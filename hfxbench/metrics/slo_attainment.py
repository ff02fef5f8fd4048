"""Share (%) of the requests due in the window that finished with TTFT
and TPOT within their task's Table-1 SLOs; unfinished ones miss."""

from hfxbench.measures import slo_attainment as read  # noqa: F401
