"""Lossless transform stages (port of ``repro.codecs``).

Torch on the CPU has no shifts, adds, ``max`` or gathers for
``uint16``/``uint32``/``uint64``, so every unsigned word travels in its
signed twin of the same width (``int16``/``int32``/``int64``): the bits
are the same and wrapping arithmetic is identical.  A logical right
shift is an arithmetic shift plus a mask (:func:`transforms.lsr`).
"""
