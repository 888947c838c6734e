"""The training runtime of the port (``repro.runtime``): the step
functions and the fault-tolerant ``Trainer`` (``runtime.trainer``)."""
from .steps import make_decode_step, make_prefill, make_train_step

__all__ = ["make_train_step", "make_prefill", "make_decode_step"]
