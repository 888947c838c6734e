"""The paper's own experimental configuration (§V): error bounds,
chunking, solver and codec choices.  Used by benchmarks and examples."""
from dataclasses import dataclass, field


@dataclass(frozen=True)
class LOPCConfig:
    # the two headline NOA bounds (Tables III-IX)
    headline_ebs: tuple = (1e-2, 1e-4)
    # the 7-point sweep (Figs. 3-4)
    sweep_ebs: tuple = (1.0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)
    eb_mode: str = "noa"
    # 16 KiB chunks (PFPL/LC convention): words per chunk by dtype width
    chunk_words: dict = field(default_factory=lambda: {4: 4096, 8: 2048})
    # codec pipelines (paper §IV-C)
    bin_pipeline: str = "delta+zigzag+BIT+RZE(+RZE_1)"      # PFPL lossless
    subbin_pipeline_f32: str = "BIT_4 RZE_4 RZE_1"          # LC-generated
    subbin_pipeline_f64: str = "BIT_8 RZE_8 RZE_1"
    # solver: auto = jacobi on CPU, blockwise (Pallas) on TPU
    solver: str = "auto"
    timeout_s: int = 3600  # paper: 'TO' after one hour


CONFIG = LOPCConfig()
