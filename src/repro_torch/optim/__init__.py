from .adamw import adamw_init, adamw_update
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "wsd_schedule"]
