"""eegflow — LSTM-ODE framework for EEG cognitive-state modeling in JAX.

A JAX/XLA framework with the capabilities of the reference
LSTM-ODE-BCI pipeline (see SURVEY.md): BrainVision ingestion, jit-able signal
preprocessing, a BiLSTM-attention eyes-open/closed classifier, a three-state
Active/Passive/Fatigued compartmental ODE integrated on-device, probabilistic
LSTM->ODE rate coupling, forecasting, explainability, ablations/statistics,
classical baselines, and figure/report generation — built for one
accelerator program per stage: static shapes, `lax.scan`/`vmap` control flow,
bf16 matmuls with f32 accumulation, and `jax.sharding` data parallelism over
a device mesh. It runs on NVIDIA GPUs, and on the CPU for tests.
"""

__version__ = "0.1.0"

from eegflow.core.config import (  # noqa: F401
    CouplingConfig,
    DataConfig,
    ModelConfig,
    ODEConfig,
    PipelineConfig,
    PreprocessConfig,
    TrainConfig,
    TransformerConfig,
)
