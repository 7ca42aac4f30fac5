"""k2_roofline, layer kernel K2 (`ffd_scan_swar`, `csrc/ffd_scan.cu`): the kernel's
share of its roofline in %, its least time on the requests whose worlds
the reference counted over its device time on them (`portbench.roofline`)."""
from portbench.roofline import kernel_share

KERNEL = ("ffd_scan_kernel", "SwarFit")  # fragments of the kernel's name on the device


def read(ctx):
    return kernel_share(ctx, *KERNEL)
