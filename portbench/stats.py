"""The arithmetic of the end-to-end rate, on plain numbers (no device): the
work of the steps enqueued before the deadline over the time until the
synchronize after them."""
from __future__ import annotations


def synced_rate(t_start: float, t_synced: float, units: int, work_per_unit: float):
    """Work per second of ``units`` units enqueued before the deadline, over
    the time until the synchronize after the last of them returned."""
    if units <= 0 or t_synced <= t_start:
        return None
    return units * work_per_unit / (t_synced - t_start)
