"""Deterministic synthetic fields (numpy copy of ``repro.data``)."""
from .fields import FIELD_GENERATORS, PAPER_INPUTS, make_scientific_field

__all__ = ["FIELD_GENERATORS", "PAPER_INPUTS", "make_scientific_field"]
