"""Multi-host runtime scaffolding (reference P5: none existed — the
reference is single-process OpenMP; SURVEY.md section 2.3).

A multi-host flow job maps onto:
  - one process per host, `jax.distributed.initialize` for the runtime,
  - a global (frames, rows, cols) mesh over all hosts' devices: halo
    collectives stay between the devices of one host, only frame-axis
    transfers (none in steady state) cross the host network,
  - frame IO partitioned by host: host h decodes frames h, h+P, h+2P, ...
    (its own VideoReader) and feeds only its addressable shards via
    `host_local_frames` + `jax.make_array_from_process_local_data`.

Single-host meshes work through the same entry points, so the multi-host
path is exercised (minus the wire) by the CPU-device-count tests.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import jax
import numpy as np

from optical_flow_tpu.parallel.mesh import AXIS_FRAMES, flow_mesh, mesh_factorization


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with env-var fallbacks; no-op if already
    initialized or single-process.

    The already-initialized probe inspects the distributed client state
    directly — anything like jax.process_count() here would itself
    initialize the XLA backend, after which jax.distributed.initialize
    refuses to run (found by tests/test_distributed.py::
    test_two_process_runtime). The probe reaches a private path that any
    JAX upgrade may rename (ADVICE r2); when it is missing, initialize is
    attempted anyway and only then is 'already initialized' treated as
    the no-op it means — nothing backend-initializing runs before it.
    """
    probe_ok = False
    try:
        from jax._src import distributed as _dist

        client = _dist.global_state.client  # may AttributeError first
        probe_ok = True  # only AFTER the probe actually resolved
        if client is not None:
            return  # already initialized
    except (ImportError, AttributeError):
        pass
    if coordinator_address is None and num_processes is None:
        return  # single process; nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        if probe_ok:
            raise  # the probe said NOT initialized: a real failure
        # private probe unavailable: double-init is one RuntimeError
        # initialize raises after a successful first call — but so are
        # genuine failures (XlaRuntimeError on a bad coordinator).
        # Distinguish by outcome: after a true double-init the runtime IS
        # multi-process; anything else must fail loudly, not silently
        # proceed single-process (including the env-var-driven launch
        # where num_processes arrives as None — round-5 review: that
        # path used to swallow every init failure).
        if num_processes is not None:
            if jax.process_count() != num_processes:
                raise
        elif jax.process_count() <= 1:
            # env-var-driven launch (num_processes None): a claimed
            # distributed runtime that is actually single-process means
            # the init FAILED — wrong-scale results otherwise
            raise


def global_flow_mesh(
    frames: Optional[int] = None,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
) -> jax.sharding.Mesh:
    """A mesh over every device of every process.

    Unspecified axes are factorized from the REMAINING device count —
    an explicitly passed axis is always honored (round-5 review:
    global_flow_mesh(frames=4) used to silently replace the 4 with the
    default factorization). Raises if the specified axes don't divide
    the device count."""
    n = len(jax.devices())
    spec = {"frames": frames, "rows": rows, "cols": cols}
    fixed = {k: v for k, v in spec.items() if v is not None}
    for k, v in fixed.items():
        if v < 1:  # 0 would slip past the divisibility guard via max(,1)
            raise ValueError(f"mesh axis {k}={v} must be >= 1")
    free = [k for k, v in spec.items() if v is None]
    prod = 1
    for v in fixed.values():
        prod *= v
    if n % max(prod, 1):
        raise ValueError(
            f"specified mesh axes {fixed} do not divide {n} devices"
        )
    rem = n // max(prod, 1)
    if len(free) == 0:
        if prod != n:
            raise ValueError(f"mesh {fixed} covers {prod} of {n} devices")
    elif len(free) == 1:
        spec[free[0]] = rem
    else:
        # factor the remainder over the free axes: reuse the 3-way
        # factorization and fold its extra factor into the first slot
        f3 = mesh_factorization(rem)
        if len(free) == 2:
            spec[free[0]] = f3[0] * f3[1]
            spec[free[1]] = f3[2]
        else:
            spec["frames"], spec["rows"], spec["cols"] = f3
    return flow_mesh(frames=spec["frames"], rows=spec["rows"], cols=spec["cols"])


def host_local_frames(
    frames: Iterable[np.ndarray],
    *,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Round-robin frame partition across hosts: host h takes frames
    h, h+P, h+2P, ... (each host runs its own decoder over the same file —
    cheaper than shipping pixels between hosts for compressed video)."""
    p = jax.process_index() if process_id is None else process_id
    P = jax.process_count() if process_count is None else process_count
    for i, frame in enumerate(frames):
        if i % P == p:
            yield frame


def make_global_batch(
    local_frames: Sequence[np.ndarray],
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Assemble each host's local frames into one global array sharded over
    the 'frames' mesh axis (jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    local = np.stack(local_frames)
    sharding = NamedSharding(mesh, P(AXIS_FRAMES))
    return jax.make_array_from_process_local_data(sharding, local)
