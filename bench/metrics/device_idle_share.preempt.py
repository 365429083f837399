"""``device_idle_share`` in ``olmo-1b.preempt``, by the same reader.  There it moves
``hi_nttft_p90``: the cell reports no ``tokens_per_s`` end to end."""
from bench import harness

read = harness.reader("device_idle_share")
