"""Exact published configs for the 10 assigned architectures (+ the
paper's own compression config in lopc.py). One module per arch;
sources cited inline per the assignment brief.  The port's copies of
``repro.configs``, word for word but for the imports."""
