"""Timing and profiling harness (reference C18 analogue).

The reference instruments with gettimeofday printf timers around each
algorithm segment (ParallelVideoPyr.cpp:37-42, serial.cpp:204-261). Here:

- `Timer`: wall-clock segment timer; pass the segment's outputs via
  `sync=` to block_until_ready them at segment end so the measurement
  covers COMPLETED device work — without it (the default) a segment
  around jitted code measures async dispatch only;
- `device_loop_time`: per-call time of a function run in an on-device
  fori_loop with perturbed inputs;
- `device_kernels` / `device_seconds_from_trace`: the reduction of a
  profiler trace to the device kernels of one jitted program;
- `PEAKS`, `stage_roofline`, `flow_roofline`: bytes/flops models against
  the published peaks of the device, keyed by `device_kind`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp


@dataclass
class Timer:
    """Named segment timers: with t.segment('solve'): ..."""

    segments: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def segment(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.segments[name] = self.segments.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.segments.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {1e3 * total:9.3f} ms total  {1e3 * total / n:9.3f} ms/call x{n}")
        return "\n".join(lines)


def device_loop_time(fn: Callable, args, iters: int = 30) -> float:
    """Seconds per call of fn(*args), measured as an on-device loop.

    fn must take arrays and return arrays; the first argument is perturbed
    per iteration so no iteration can reuse another's result, and outputs
    are reduced to a scalar so nothing leaves the device between
    iterations.
    """

    @jax.jit
    def loop(*a):
        def body(i, acc):
            out = fn(a[0] + i * jnp.float32(1e-7), *a[1:])
            leaves = jax.tree_util.tree_leaves(out)
            return acc + sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

    jax.block_until_ready(loop(*args))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(loop(*args))
    return (time.perf_counter() - t0) / iters


def device_kernels(trace_dir: str, fn_name: str) -> List[Tuple[str, int]]:
    """(kernel name, device nanoseconds) of every kernel that the jitted
    function `fn_name` ran, read from the newest `.xplane.pb` under
    `trace_dir`.

    On a GPU trace each device plane ('/device:GPU:N') holds one line per
    stream, and every kernel event carries the `hlo_module` of its
    program — 'jit_<fn_name>' for `jax.jit(fn_name)`. Raises if the trace
    holds no device kernel of that program: a time that silently fell back
    to the host clock would not be a device time.
    """
    import glob
    import os

    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not files:
        raise RuntimeError(f"no .xplane.pb profile under {trace_dir}")
    module = f"jit_{fn_name}"
    kernels = []
    data = ProfileData.from_file(max(files, key=os.path.getmtime))
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if dict(ev.stats).get("hlo_module") == module:
                    kernels.append((ev.name, int(ev.duration_ns)))
    if not kernels:
        raise RuntimeError(
            f"trace under {trace_dir} has no device kernel of {module}"
        )
    return kernels


def device_seconds_from_trace(trace_dir: str, fn_name: str,
                              expected_calls: int) -> float:
    """Summed device seconds of the jitted program `fn_name` in a profiler
    trace (`device_kernels`). Raises if the trace holds fewer kernels than
    `expected_calls`: every call launches at least one."""
    kernels = device_kernels(trace_dir, fn_name)
    if len(kernels) < expected_calls:
        raise RuntimeError(
            f"trace has {len(kernels)} kernels of jit_{fn_name}, fewer than "
            f"the {expected_calls} calls made"
        )
    return sum(d for _, d in kernels) / 1e9


# Published peaks per device kind (NVIDIA H100 SXM data sheet, dense
# rates at the full 700 W power limit): HBM bytes/s and float32 FLOP/s
# outside the tensor cores, which is what the elementwise and stencil
# stages run on. A device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}


def peaks(device_kind: str) -> Dict[str, float]:
    """The `PEAKS` entry of a device kind (`jax.devices()[0].device_kind`)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "utils/profiling.PEAKS"
        ) from None


def stage_roofline(
    bytes_moved: float,
    flops: float,
    measured_us: float,
    *,
    device_kind: str,
) -> Dict[str, float]:
    """Achieved-vs-ceiling fractions for one pipeline stage.

    bytes_moved: the stage's HBM floor — the bytes that MUST cross HBM if
    XLA fused the whole stage perfectly (stage inputs + stage outputs).
    flops: estimated float32 flops. measured_us: the stage's measured
    device time.

    Returns the two ceilings (sol_hbm_us, sol_f32_us) and the achieved
    fractions pct_of_hbm_roofline / pct_of_f32_peak (100 = the stage runs
    AT that ceiling; both are lower bounds on true efficiency when the
    floor under-counts unavoidable traffic). `bound` names the larger
    ceiling — the one worth optimizing against."""
    pk = peaks(device_kind)
    t_mem_us = bytes_moved / (pk["hbm_gbps"] * 1e3)
    t_f32_us = flops / (pk["f32_tflops"] * 1e6)
    measured_us = max(measured_us, 1e-9)
    return {
        "measured_us": measured_us,
        "sol_hbm_us": t_mem_us,
        "sol_f32_us": t_f32_us,
        "pct_of_hbm_roofline": 100.0 * t_mem_us / measured_us,
        "pct_of_f32_peak": 100.0 * t_f32_us / measured_us,
        "bound": "memory" if t_mem_us >= t_f32_us else "compute",
    }


def io_bytes(fn, *args) -> int:
    """HBM floor of a jittable stage: input bytes + output bytes (via
    jax.eval_shape — no execution). The perfect-fusion lower bound
    `stage_roofline` consumes."""
    import numpy as np

    out = jax.eval_shape(fn, *args)
    leaves = jax.tree_util.tree_leaves(args) + jax.tree_util.tree_leaves(out)
    return int(
        sum(
            np.prod(l.shape) * np.dtype(l.dtype).itemsize
            for l in leaves
            if hasattr(l, "shape")
        )
    )


def flow_roofline(h: int, w: int, *, device_kind: str) -> Dict[str, float]:
    """Speed-of-light model for one fused dense-LK level.

    HBM traffic: 2 image reads + 2 flow writes, 4 B/px each (everything
    else stays on chip). Compute: ~70 float32 flops/px (gradients 20,
    products 5, window sums 30, solve ~15).
    """
    pk = peaks(device_kind)
    px = h * w
    bytes_moved = 16.0 * px
    flops = 70.0 * px
    t_mem = bytes_moved / (pk["hbm_gbps"] * 1e9)
    t_compute = flops / (pk["f32_tflops"] * 1e12)
    t = max(t_mem, t_compute)
    return {
        "bytes": bytes_moved,
        "flops": flops,
        "t_mem_us": 1e6 * t_mem,
        "t_compute_us": 1e6 * t_compute,
        "sol_us": 1e6 * t,
        "sol_fps": 1.0 / t,
        "bound": "memory" if t_mem >= t_compute else "compute",
    }
