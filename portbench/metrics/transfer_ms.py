"""transfer_ms (layer: operand upload and answer fetch): a request's
upload of the packed operands and fetch of the answers to the host, in ms
on the card's clock (CUDA events around each), the mean over the traced
window's requests."""


def read(ctx):
    times = ctx["transfer_ms"]
    return sum(times) / len(times) if times else None
