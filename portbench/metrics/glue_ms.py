"""glue_ms (layer: scan glue): a request's device time in every activity
but the scan kernels and the copies of operands and answers between host
and card (the sorts, gathers, stream build, probe and finish), in ms, the
mean over the traced window's requests."""

SCAN_KERNELS = ("ffd_scan_kernel", "ffd_scan_aff_kernel")
TRANSFERS = ("Memcpy HtoD", "Memcpy DtoH")


def read(ctx):
    summary = ctx["trace"]
    if summary is None or not summary.requests:
        return None
    glue = [
        sum(s for n, s in r.items()
            if not any(k in n for k in SCAN_KERNELS) and not n.startswith(TRANSFERS))
        for r in summary.requests
    ]
    return 1e3 * sum(glue) / len(glue)
