"""Split-KV decode attention's share of its roofline over the traced
window (``afdbench.work.splitkv_work``: live keys only)."""

LAYER = "kernels/splitkv_attention"
UNIT = "%"
MOVES = "itl_p95_s"


def read(t):
    from afdbench import roofline
    return roofline.share(t, "splitkv")
