"""Device time of a torch.profiler trace, as the profile_* scripts read
it."""
from __future__ import annotations

from torch.autograd import DeviceType


def device_kernels(events):
    """The CUDA kernels of a trace's ``key_averages()``, by device time
    (largest first), their summed self time in ms and their launch
    count. Only kernels are summed: an operator's own row repeats its
    kernels' time."""
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return kernels, busy, sum(e.count for e in kernels)
