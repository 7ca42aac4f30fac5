"""k3.ms, layer kernel K3 (`ffd_scan_aff`, `csrc/ffd_scan_affinity.cu`): the kernel's device
time a request in ms, the mean over the traced window's requests that
launched it; nothing where none did."""
from portbench.trace import kernel_ms

KERNEL = ("ffd_scan_aff_kernel",)  # fragments of the kernel's name on the device


def read(ctx):
    return kernel_ms(ctx["trace"], *KERNEL)
