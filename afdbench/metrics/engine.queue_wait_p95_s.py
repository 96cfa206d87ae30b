"""95th percentile, over the requests due in the window and given a slot
before the profiler started, of the time from when a request was due to
the start of the tick that gave it a slot (the harness's view of
``engine.queue`` and the micro-batch slots). Below the knee it is the
queueing part of TTFT; a queue that grows, because admission no longer
keeps up with the offered load, is what makes ``tokens_per_s`` fall."""

LAYER = "serving/afd_engine"
UNIT = "s"
MOVES = "tokens_per_s"


def read(t):
    return t.queue_wait_p95_s
