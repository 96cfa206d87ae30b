"""Flash prefill's share of its roofline over the traced window
(``afdbench.work.flash_prefill_work``: live (row, key) pairs only)."""

LAYER = "kernels/flash_prefill"
UNIT = "%"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import roofline
    return roofline.share(t, "flash_prefill")
