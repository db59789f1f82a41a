"""Phase timing + device profiling — the ATP-profiler equivalent.

The reference wires a registry of named cycle timers through macros
(ATP_REGISTER/ATP_START/ATP_END, SURVEY.md §5.1) and prints a report at
exit (app.cpp:264-293). Translation here:

- ``Phase("name")`` context manager: wall-clock phase timers collected in
  a process-global registry (load / build / render / backward ...), with
  optional ``jax.named_scope`` so phases are visible in device traces;
- ``phase_report()``: the end-of-run table (the print_out_tests analog),
  also exportable as a JSON dict for the metrics pipeline (SURVEY.md §5.5);
- ``trace_to(dir)``: wraps ``jax.profiler.trace`` for TensorBoard/Perfetto
  device timelines — the per-tile ATP multi-timer analog is per-kernel
  device timing in the trace;
- ``gpu_card()``: the card's name and power limit as ``nvidia-smi`` reports
  them, to print beside every number taken on it.

Phase timers measure wall clock: JAX returns before the device finishes, so
pass ``block=True`` to time device work.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from typing import Dict, List, Optional

import jax

_REGISTRY: Dict[str, List[float]] = {}


class Phase:
    """Context manager timing one named phase (re-enterable; every run is
    recorded, like the reference's MULTI test slots)."""

    def __init__(self, name: str, block: bool = False):
        self.name = name
        self.block = block
        self._t0 = 0.0

    def __enter__(self):
        self._scope = jax.named_scope(self.name)
        self._scope.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.block:
            # ensure device work inside the phase is actually finished
            try:
                jax.effects_barrier()
            except Exception:
                pass
        _REGISTRY.setdefault(self.name, []).append(
            time.perf_counter() - self._t0
        )
        self._scope.__exit__(*exc)
        return False


def reset_phases() -> None:
    _REGISTRY.clear()


def phase_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, runs in _REGISTRY.items():
        out[name] = {
            "runs": len(runs),
            "total_s": sum(runs),
            "mean_s": sum(runs) / len(runs),
            "min_s": min(runs),
            "max_s": max(runs),
        }
    return out


def phase_report(rays: Optional[int] = None, file=None) -> str:
    """Printable table of all phases (the print_out_tests analog); if
    ``rays`` is given, appends the headline rays/s metric computed from the
    'render' phase (the reference's ms/ray print, app.cpp:194-195)."""
    stats = phase_stats()
    lines = [f"{'phase':<24}{'runs':>6}{'total':>12}{'mean':>12}"]
    for name, s in sorted(stats.items()):
        lines.append(
            f"{name:<24}{s['runs']:>6}{s['total_s']:>11.3f}s{s['mean_s']:>11.3f}s"
        )
    if rays is not None and "render" in stats:
        rps = rays / stats["render"]["min_s"]
        lines.append(f"{'rays/s (best render)':<24}{rps:>18.3e}")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


def metrics_json(extra: Optional[dict] = None) -> str:
    """Machine-readable metrics line (SURVEY.md §5.5 structured logging)."""
    payload = {"phases": phase_stats()}
    if extra:
        payload.update(extra)
    return json.dumps(payload)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Device profiler trace (TensorBoard `profile` plugin / Perfetto)."""
    with jax.profiler.trace(log_dir):
        yield


def gpu_card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card, read by a child process that stays off JAX.
    Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()
