"""Scaling reports of the distributed sort: not ported yet.

Counterpart of `vulkan_radix_sort_tpu/parallel/scaling.py` (`phase_report`,
`dcn_report`, `scaling_report`), a later slice (ROADMAP.md, queue 1, step
14). Until then each raises NotImplementedError; `sort_sharded`'s
`phase_times=` gives one sort's wall time per phase meanwhile.
"""

from __future__ import annotations


def _not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"parallel.scaling.{name} is not ported "
                                  "yet")
    refuse.__name__ = name
    return refuse


phase_report = _not_ported("phase_report")
dcn_report = _not_ported("dcn_report")
scaling_report = _not_ported("scaling_report")
