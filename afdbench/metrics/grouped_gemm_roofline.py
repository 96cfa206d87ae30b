"""The grouped GEMM's share of its roofline over the traced window: the
least time of every call (``afdbench.work.grouped_gemm_work`` on the
inputs the kernel front door saw) over the device time of the kernels
launched inside the calls' ranges."""

LAYER = "kernels/grouped_gemm"
UNIT = "%"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import roofline
    return roofline.share(t, "grouped_gemm")
