"""The benchmark's harness: general code that finds a cell's pieces by
name (``spec``), makes its inputs (``fields``, ``traffic``), drives the
program (``program``), times (``run``) and reads device traces
(``profile``)."""
