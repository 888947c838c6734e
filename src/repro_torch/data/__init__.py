"""Deterministic synthetic fields and the synthetic LM stream (numpy
copies of ``repro.data``)."""
from .fields import FIELD_GENERATORS, PAPER_INPUTS, make_scientific_field
from .pipeline import SyntheticLMStream

__all__ = ["FIELD_GENERATORS", "PAPER_INPUTS", "SyntheticLMStream",
           "make_scientific_field"]
