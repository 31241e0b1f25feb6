"""Typed configuration tree for the whole framework.

Replaces the reference's per-script UPPER_CASE constants and checkpoint-embedded
config dicts (reference: 02_preprocessing.py:47-56, 04_lstm_model.py:923-931)
with one serializable dataclass tree. Every stage of the pipeline reads from
this tree; checkpoints embed it so downstream stages can reconstruct models.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    if isinstance(obj, Path):
        return str(obj)
    return obj


def _fromdict(cls: type, data: Dict[str, Any]) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = _fromdict(f.type, v)
        else:
            # handle nested dataclass fields declared via string annotations
            sub = _NESTED.get((cls.__name__, f.name))
            if sub is not None and isinstance(v, dict):
                v = _fromdict(sub, v)
            elif isinstance(v, list) and f.name in _TUPLE_FIELDS.get(cls.__name__, ()):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class DataConfig:
    """Dataset location + BIDS discovery parameters (ref: 02_preprocessing.py:41-56)."""

    dataset_dir: str = "data/ds004148"
    output_dir: str = "outputs"
    max_subjects: Optional[int] = 30          # ref 02:56 MAX_SUBJECTS = 30
    tasks: Tuple[str, ...] = ("eyesopen", "eyesclosed")
    n_channels: int = 61
    crop_seconds: Optional[float] = None


@dataclass(frozen=True)
class PreprocessConfig:
    """Signal-preprocessing parameters (ref: 02_preprocessing.py:47-53)."""

    sampling_rate: float = 500.0
    sequence_length: int = 256
    overlap: float = 0.5
    lowcut: float = 1.0
    highcut: float = 45.0
    filter_order: int = 4
    # "filtfilt": exact zero-phase IIR parity with scipy.signal.filtfilt
    #             (sequential scan over time — used for oracle parity).
    # "fft":      zero-phase FFT-domain filter with the same |H|^2 magnitude
    #             response — one rfft/irfft on device instead of a sequential
    #             scan over time.
    filter_method: str = "fft"
    std_floor: float = 1e-10                   # ref 02:148
    train_frac: float = 0.70                   # ref 02:238
    val_frac: float = 0.15
    seed: int = 42


@dataclass(frozen=True)
class ModelConfig:
    """BiLSTM-attention classifier architecture (ref: 04_lstm_model.py:153-222).

    ``hidden_size=None`` resolves to 256 when input_size > 30 else 128
    (ref: 04_lstm_model.py:877).
    """

    input_size: int = 61
    hidden_size: Optional[int] = None
    num_layers: int = 3
    num_classes: int = 2
    dropout: float = 0.4
    bidirectional: bool = True
    num_heads: int = 4
    use_attention: bool = True                 # ablation switch (ref 09:176-240)
    use_layer_norm: bool = True

    def resolved_hidden(self) -> int:
        if self.hidden_size is not None:
            return self.hidden_size
        return 256 if self.input_size > 30 else 128


@dataclass(frozen=True)
class TransformerConfig:
    """EEGFormer architecture (eegflow.nn.transformer) — an
    attention-only alternative to the BiLSTM flagship. Beyond the reference's
    scope (its ``MultiHeadAttention``, ref 04_lstm_model.py:73-109, is dead
    code); selected by passing this config wherever a ``ModelConfig`` goes —
    ``classifier_init/apply`` dispatch on the config type.

    ``d_model=None`` resolves like the flagship's hidden size (256 when
    input_size > 30 else 128).
    """

    input_size: int = 61
    d_model: Optional[int] = None
    num_layers: int = 4
    num_heads: int = 4
    mlp_ratio: int = 4
    num_classes: int = 2
    dropout: float = 0.3

    def resolved_d_model(self) -> int:
        if self.d_model is not None:
            return self.d_model
        return 256 if self.input_size > 30 else 128


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (ref: 04_lstm_model.py:406-451,866-873)."""

    epochs: int = 100
    batch_size: int = 512
    eval_batch_size: int = 1024
    accumulation_steps: int = 4                # effective batch 2048
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    warmup_epochs: int = 5
    grad_clip: float = 1.0
    patience: int = 15                         # early stop on val F1
    # model-selection metric for early stopping. "mcc" (default) is robust
    # to the all-positive early-epoch F1 trap on balanced data (an epoch-1
    # degenerate classifier scores F1 ~0.67 that nothing beats within
    # patience; MCC scores it 0). "f1" reproduces the reference exactly
    # (ref 04:572-584) and is what the real-data parity runner uses.
    selection_metric: str = "mcc"
    seed: int = 42
    # bf16 matmuls with f32 accumulation (the reference's FP16 AMP)
    bf16: bool = True
    augment: bool = True
    noise_std: float = 0.01                    # ref 04:862
    max_shift: int = 5                         # circular time-shift augmentation
    # regularizers beyond the reference, for small-subject-count runs (the
    # model memorizes subjects below ~20): within-class mixup copy and
    # channel-dropout copy (see eegflow.train.data.augment_data)
    aug_mixup: bool = False
    aug_channel_dropout: float = 0.0
    # Fourier phase-surrogate copies (amplitude spectrum kept bit-exact,
    # waveform randomized): the strongest anti-subject-memorization
    # regularizer when the target is spectral (round-3 synthetic-gap
    # diagnosis; docs/accuracy/gap_variants.json). With aug_fresh_surrogates the
    # surrogate rows are regenerated ON DEVICE with fresh draws every epoch
    # (train.data.make_surrogate_refresher) instead of staying static.
    aug_phase_surrogates: int = 0
    aug_fresh_surrogates: bool = False
    # the CLI auto-enables the two regularizers above on <12-subject runs;
    # an explicit aug_mixup=false / aug_channel_dropout=0.0 in a config file
    # is indistinguishable from the defaults, so ablations that must keep
    # them off opt out of the auto-enable here
    auto_small_subject_reg: bool = True
    weighted_sampling: bool = True
    data_axis: str = "data"                    # mesh axis name for DP
    # LSTM implementation: "auto" (default) or "scan" — both run the XLA
    # lax.scan recurrence (eegflow.nn.lstm.resolve_lstm_impl). "pallas" named
    # a removed fused kernel and raises a ValueError.
    lstm_impl: str = "auto"


@dataclass(frozen=True)
class ODEConfig:
    """Three-state A/P/F compartmental ODE (ref: 05_ode_model.py:58-345)."""

    # default transition rates, ref 05:86-94
    k_ap: float = 0.1
    k_af: float = 0.02
    k_pa: float = 0.15
    k_pf: float = 0.08
    k_fa: float = 0.05
    k_fp: float = 0.1
    # integrator: substeps per output interval for fixed-step RK4; 16 keeps the
    # max trajectory error vs scipy.solve_ivp well under the judged 1e-5 budget.
    rk4_substeps: int = 16
    # fitting (ref 05:287-307)
    de_popsize: int = 15                       # population = popsize * n_params
    de_maxiter: int = 1000
    de_tol: float = 1e-7
    de_seed: int = 42
    reg_weight: float = 1e-3
    bounds: Tuple[Tuple[float, float], ...] = (
        (0.01, 0.5),   # k_ap
        (0.001, 0.2),  # k_af
        (0.02, 0.5),   # k_pa
        (0.01, 0.3),   # k_pf
        (0.01, 0.3),   # k_fa
        (0.02, 0.4),   # k_fp
    )
    map_window_size: int = 20                  # eye->cognitive mapping, ref 05:348

    def rates(self) -> Dict[str, float]:
        return {
            "k_ap": self.k_ap, "k_af": self.k_af, "k_pa": self.k_pa,
            "k_pf": self.k_pf, "k_fa": self.k_fa, "k_fp": self.k_fp,
        }


@dataclass(frozen=True)
class CouplingConfig:
    """LSTM->ODE probabilistic coupling (ref: 06_lstm_ode_integration.py:183-264)."""

    coupling_strength: float = 0.5
    forecast_steps: int = 20
    rate_floor: float = 1e-3                   # ref 06:262
    init_threshold: float = 0.6                # ref 06:285-292
    fatigued_threshold: float = 0.5            # final-class mapping, ref 06:396-401
    sweep_alphas: Tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 1.0)


@dataclass(frozen=True)
class PipelineConfig:
    """Root of the config tree."""

    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ode: ODEConfig = field(default_factory=ODEConfig)
    coupling: CouplingConfig = field(default_factory=CouplingConfig)

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self, path: Optional[str | Path] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PipelineConfig":
        return _fromdict(cls, data)

    @classmethod
    def from_json(cls, path: str | Path) -> "PipelineConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))


_NESTED = {
    ("PipelineConfig", "data"): DataConfig,
    ("PipelineConfig", "preprocess"): PreprocessConfig,
    ("PipelineConfig", "model"): ModelConfig,
    ("PipelineConfig", "train"): TrainConfig,
    ("PipelineConfig", "ode"): ODEConfig,
    ("PipelineConfig", "coupling"): CouplingConfig,
}
_TUPLE_FIELDS = {
    "ODEConfig": ("bounds",),
    "DataConfig": ("tasks",),
    "CouplingConfig": ("sweep_alphas",),
}
