"""Device measurement: published peaks, host-clock timing, trace reduction.

* :data:`PEAKS` — published dense peak rates keyed by
  ``jax.Device.device_kind``. A kind missing from the table is an error, not
  a default: an MFU against the wrong peak is worse than none.
* :func:`card_info` — the card's name and power limit as ``nvidia-smi``
  reports them. A card set below its maximum power runs slower under load,
  so every number is reported beside it.
* :func:`time_calls` — compile and steady time on the host clock around
  ``block_until_ready`` (JAX returns before the device finishes).
* :func:`trace_breakdown` — device time per category from a
  ``jax.profiler`` trace, read with ``jax.profiler.ProfileData`` alone.
  Each device op is attributed through its ``op_name`` metadata in the
  compiled HLO text, where ``jax.named_scope`` names (``input_block``,
  ``lstm_l0_fwd``, ``attention_pool``, ``head``) survive; ops inside a
  ``while`` body are the ``lax.scan`` recurrences.

Replaces the reference's ``time.time()`` spans (ref 04_lstm_model.py:427,
06_lstm_ode_integration.py:458-467).
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

#: Published dense (no sparsity) peaks per device kind, with their source.
#: The rates assume the card's full power limit.
PEAKS: Dict[str, Dict[str, object]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 (700 W)",
    },
}


def peak_for(device_kind: str) -> Dict[str, object]:
    """The :data:`PEAKS` entry for ``device_kind``; KeyError if absent."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device kind {device_kind!r}; add it to "
            "eegflow.core.profiling.PEAKS with its source") from None


def mfu(flops_per_step: float, step_s: float, n_devices: int,
        device_kind: str) -> float:
    """Model FLOP/s utilization against the bf16 dense peak."""
    peak = float(peak_for(device_kind)["bf16_flops"])
    return flops_per_step / step_s / (n_devices * peak)


def card_info() -> Optional[str]:
    """``name, power.limit`` of every visible NVIDIA card (one per line), or
    None when ``nvidia-smi`` is absent or fails. Starts no JAX backend."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else None


def time_calls(fn: Callable[[], object], n: int) -> Tuple[float, float, object]:
    """``(first_s, steady_s, result)``: the first call (compile + run) and
    the mean of the next ``n`` calls, each ended by
    ``jax.block_until_ready``; ``result`` is the last call's."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn())
    return first, (time.perf_counter() - t0) / max(n, 1), out


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------


@dataclass
class DeviceOp:
    """One op execution on a device, from the trace."""

    module: str
    op: str
    start_ns: float
    duration_ns: float
    kernel: str = ""       # the trace event's own name (the GPU kernel's)


@dataclass
class Breakdown:
    """Device time of a traced window, per category."""

    seconds: Dict[str, float] = field(default_factory=dict)
    busy_s: float = 0.0        # union of op intervals
    window_s: float = 0.0      # first op start to last op end
    n_ops: int = 0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0

    def shares(self) -> Dict[str, float]:
        total = sum(self.seconds.values())
        return {k: v / total for k, v in self.seconds.items()} if total else {}


def newest_xplane(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return files[-1]


def device_ops(xplane_path: str, plane_prefix: str = "/device:") -> List[DeviceOp]:
    """Every event carrying an ``hlo_op`` stat on the planes whose name
    starts with ``plane_prefix`` (``/device:GPU:0`` on a card; the CPU
    backend's ops are on ``/host:CPU``). Kernels launched from a CUDA graph
    carry ``hlo_op="command_buffer"``; their own name identifies them."""
    from jax.profiler import ProfileData

    ops = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats:
                    continue
                ops.append(DeviceOp(str(stats.get("hlo_module", "")),
                                    str(stats["hlo_op"]), float(ev.start_ns),
                                    float(ev.duration_ns), str(ev.name)))
    return ops


_COMP_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_BODY_RE = re.compile(r"\bbody=%?([\w.\-]+)")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_WHILE_RE = re.compile(r"=.*\swhile\(")
_KERNEL_SUFFIX_RE = re.compile(r"^(.*)_(\d+)$")

#: label of a ``while`` instruction itself: a container whose trace event
#: (where a backend emits one) spans its body's ops, so it is not counted
WHILE_CONTAINER = "<while>"


def hlo_op_labels(hlo_text: str) -> Dict[str, str]:
    """Map each instruction of a compiled HLO module to a label: its
    ``op_name`` metadata, prefixed ``while/`` when the instruction sits in
    a while-loop body (a ``lax.scan`` step). ``while`` instructions get
    :data:`WHILE_CONTAINER`."""
    bodies = set(_BODY_RE.findall(hlo_text))
    labels: Dict[str, str] = {}
    comp = ""
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if m is None:
            c = _COMP_RE.match(line)
            if c is not None:
                comp = c.group(1)
            continue
        if _WHILE_RE.search(line):
            labels[m.group(1)] = WHILE_CONTAINER
            continue
        name = _OPNAME_RE.search(line)
        label = name.group(1) if name else ""
        labels[m.group(1)] = ("while/" if comp in bodies else "") + label
    return labels


def op_label(op: DeviceOp, labels: Mapping[str, str]) -> Optional[str]:
    """The label of ``op``'s HLO instruction, or None. An op run inside a
    command buffer is found by its kernel name, which is the instruction's
    name with ``_N`` for ``.N`` (``loop_add_fusion_52`` ->
    ``loop_add_fusion.52``)."""
    label = labels.get(op.op)
    if label is not None:
        return label
    label = labels.get(op.kernel)
    if label is None:
        m = _KERNEL_SUFFIX_RE.match(op.kernel)
        if m is not None:
            label = labels.get(f"{m.group(1)}.{m.group(2)}")
    return label


def trace_breakdown(
    ops: Sequence[DeviceOp],
    labels: Mapping[str, str],
    categories: Sequence[Tuple[str, str]],
    module: Optional[str] = None,
) -> Breakdown:
    """Sum device time per category.

    ``categories`` is an ordered list of ``(name, regex)``; an op goes to
    the first whose regex matches its label (:func:`hlo_op_labels`,
    :func:`op_label`), to ``"other"`` when none does, and to
    ``"unattributed"`` when it has no label (a library kernel inside a
    command buffer, for one). ``module`` keeps only that HLO module's ops. While
    containers are skipped: their body ops are counted one by one.
    """
    compiled = [(n, re.compile(p)) for n, p in categories]
    out = Breakdown()
    spans = []
    for op in ops:
        if module is not None and op.module != module:
            continue
        label = op_label(op, labels)
        if label == WHILE_CONTAINER:
            continue
        if label is None:
            cat = "unattributed"
        else:
            cat = next((n for n, rx in compiled if rx.search(label)), "other")
        out.seconds[cat] = out.seconds.get(cat, 0.0) + op.duration_ns * 1e-9
        spans.append((op.start_ns, op.start_ns + op.duration_ns))
    out.n_ops = len(spans)
    if spans:
        spans.sort()
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        out.busy_s = busy * 1e-9
        out.window_s = (max(e for _, e in spans) - spans[0][0]) * 1e-9
    return out


#: the train step's categories, in match order
TRAIN_STEP_CATEGORIES: Tuple[Tuple[str, str], ...] = (
    ("recurrence", r"^while/"),
    ("lstm_input_proj", r"lstm_l\d+_(fwd|bwd)"),
    ("input_block", r"input_block"),
    ("attention_pool", r"attention_pool"),
    ("head", r"[/(]head[/)]"),
)
