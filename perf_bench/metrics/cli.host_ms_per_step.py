"""ms per step of the B = 1 loop outside K2 (`cli._run_episodes`,
`_policy_act`, the env's step and its host syncs): the traced span's time
per step less K2's device time per step in it. Both come from the same
steps: K2's time at B = 1 moves with the episode's contacts, so a median
over the whole window less K2's median over the span can read below
zero."""
from perf_bench.readers import host_ms_per_step as read  # noqa: F401
