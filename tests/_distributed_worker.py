"""Worker process for the real multi-process distributed test.

Launched (twice) by tests/test_distributed.py::test_two_process_runtime.
Each process owns 4 virtual CPU devices; together they form the 8-device
global runtime the single-process tests emulate. This executes the
multi-host path the reference never had (SURVEY.md P5):
`jax.distributed.initialize` -> global mesh -> per-host frame IO ->
`make_array_from_process_local_data` -> a sharded flow step + collectives.

Usage: python _distributed_worker.py <coordinator> <num_procs> <process_id>
Prints "WORKER_OK <pid>" on success; any assertion kills the exit code.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main() -> None:
    coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from optical_flow_tpu.parallel.distributed import (
        global_flow_mesh,
        host_local_frames,
        initialize_distributed,
        make_global_batch,
    )

    initialize_distributed(
        coordinator_address=coordinator, num_processes=num_procs, process_id=pid
    )
    assert jax.process_count() == num_procs, jax.process_count()
    assert jax.process_index() == pid
    assert len(jax.devices()) == 4 * num_procs, len(jax.devices())
    assert len(jax.local_devices()) == 4

    # Global mesh over every device of every process; frames ride the
    # cross-process axis so only frame-parallel work crosses the wire.
    mesh = global_flow_mesh(frames=num_procs * 2, rows=2, cols=1)

    # Deterministic "video": every host generates the same stream, then
    # keeps its round-robin share (host_local_frames) — the distributed
    # IO contract (each host runs its own decoder over the same file).
    r = np.random.RandomState(42)
    all_frames = [r.rand(64, 128).astype(np.float64) for _ in range(num_procs * 4)]
    local = list(
        host_local_frames(iter(all_frames), process_id=pid, process_count=num_procs)
    )
    assert len(local) == 4  # stream frames pid, pid+P, pid+2P, pid+3P
    assert np.array_equal(local[0], all_frames[pid])

    # Assemble global sharded batches from per-host shards: this host's
    # local pairs are (local[0], local[2]) and (local[1], local[3]).
    img1 = make_global_batch(local[:2], mesh)
    img2 = make_global_batch(local[2:], mesh)
    assert img1.shape == (num_procs * 2, 64, 128)

    from optical_flow_tpu.flow.lk import lucas_kanade
    from optical_flow_tpu.parallel.sharded_lk import sharded_lucas_kanade

    u, v = sharded_lucas_kanade(img1, img2, mesh)

    # Which global batch rows did THIS host's local rows land on? Derive
    # from the assembled array itself rather than assuming device order.
    my_rows = sorted({s.index[0].start for s in img1.addressable_shards})
    assert len(my_rows) == 2, my_rows
    # Oracle: unsharded single-process LK on this host's own pairs; each
    # host checks its addressable shards — bit-identity across the
    # process boundary, the same claim the 1-process tests make.
    oracle = {
        b: lucas_kanade(jnp.asarray(local[li]), jnp.asarray(local[li + 2]))
        for li, b in enumerate(my_rows)
    }
    checked = 0
    for shard_u, shard_v in zip(u.addressable_shards, v.addressable_shards):
        bsl, rsl, csl = shard_u.index
        for b in range(bsl.start or 0, bsl.stop if bsl.stop else u.shape[0]):
            ou, ov = oracle[b]
            np.testing.assert_array_equal(
                np.asarray(shard_u.data)[b - (bsl.start or 0)],
                np.asarray(ou)[rsl, csl],
            )
            np.testing.assert_array_equal(
                np.asarray(shard_v.data)[b - (bsl.start or 0)],
                np.asarray(ov)[rsl, csl],
            )
            checked += 1
    assert checked >= 2, checked

    # A cross-process collective: global mean of u via psum over the full
    # mesh (the reduction pattern the distributed BA Schur solve uses).
    # The mean is order-invariant, so every host can compute the oracle
    # over the whole stream without knowing the global row order.
    from functools import partial
    from jax.sharding import PartitionSpec as P

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P("frames", "rows", None),
        out_specs=P(),
    )
    def global_mean(x):
        s = jnp.sum(x)
        s = jax.lax.psum(s, ("frames", "rows"))  # cols=1 in this mesh
        return (s / (u.shape[0] * u.shape[1] * u.shape[2]))[None]

    gm = float(np.asarray(jax.jit(global_mean)(u))[0])
    acc = []
    for p in range(num_procs):
        for li in range(2):
            a = jnp.asarray(all_frames[p + num_procs * li])
            bb = jnp.asarray(all_frames[p + num_procs * (li + 2)])
            acc.append(np.mean(np.asarray(lucas_kanade(a, bb)[0])))
    assert abs(gm - float(np.mean(acc))) < 1e-9, (gm, float(np.mean(acc)))

    # ---- the FULL sharded pyramid with tiled warps across the process
    # boundary (VERDICT r2 missing #4): a (rows=2, cols=P*2) spatial mesh
    # puts the two row-tiles on DIFFERENT processes, so every exchange_halo
    # ppermute (LK stencil halos AND the shift_sep warp halos) crosses the
    # wire. Oracle: the unsharded controller on the same (deterministic)
    # pair — bit-identity checked per addressable shard.
    from jax.sharding import NamedSharding
    from optical_flow_tpu.config import FlowConfig
    from optical_flow_tpu.flow.coarse_to_fine import coarse_to_fine
    from optical_flow_tpu.parallel.sharded_flow import sharded_coarse_to_fine

    mesh_sp = global_flow_mesh(frames=1, rows=2, cols=2 * num_procs)
    # rows axis spans the process boundary in this device order; assert so
    # (the test's whole point is halos over the wire)
    dev = np.asarray(mesh_sp.devices).reshape(2, 2 * num_procs)
    assert {d.process_index for d in dev[0]} != {
        d.process_index for d in dev[1]
    }, "mesh rows do not cross the process boundary"
    ia = all_frames[0]
    ib = all_frames[1]
    sh = NamedSharding(mesh_sp, P("rows", "cols"))
    ga = jax.make_array_from_callback((64, 128), sh, lambda idx: ia[idx])
    gb = jax.make_array_from_callback((64, 128), sh, lambda idx: ib[idx])
    cfg = FlowConfig(warp_clamp=4.0, warp_impl="shift_sep")
    # jit: eager ops cannot touch non-fully-addressable global arrays
    u2, v2 = jax.jit(
        lambda a, b: sharded_coarse_to_fine(
            a, b, mesh_sp, 2, config=cfg, min_tile=8
        )
    )(ga, gb)
    # oracle jitted too: the eager op-by-op oracle contracts mul+add
    # without FMA while XLA:CPU fuses them under jit — a pure compilation
    # artifact (single-process bit-identity is pinned eager-vs-eager in
    # test_parallel.py); the cross-process claim here is checked at f64
    # roundoff
    ou, ov = jax.jit(
        lambda a, b: coarse_to_fine(a, b, 2, config=cfg)
    )(jnp.asarray(ia), jnp.asarray(ib))
    ou, ov = np.asarray(ou), np.asarray(ov)
    checked = 0
    for su, sv in zip(u2.addressable_shards, v2.addressable_shards):
        np.testing.assert_allclose(
            np.asarray(su.data), ou[su.index], atol=1e-12, rtol=0
        )
        np.testing.assert_allclose(
            np.asarray(sv.data), ov[sv.index], atol=1e-12, rtol=0
        )
        checked += 1
    assert checked >= 4, checked

    # ---- distributed bundle adjustment: points/observations sharded over
    # the full mesh (both processes), cameras replicated; every GN
    # iteration's camera system is assembled by a psum that crosses the
    # process boundary. Oracle: the unsharded solver on the same problem.
    from optical_flow_tpu.slam.ba import (
        BAProblem,
        bundle_adjust,
        sharded_bundle_adjust,
    )

    rngb = np.random.RandomState(7)
    C, Pn = 4, 32
    pts_true = np.stack(
        [rngb.randn(Pn) * 1.5, rngb.randn(Pn), rngb.uniform(4, 9, Pn)], axis=1
    )
    cams_true = np.zeros((C, 6))
    cams_true[:, 3] = np.arange(C) * 0.3
    obs_list, ci_list, pi_list = [], [], []
    focal = 400.0
    for c in range(C):
        Xc = pts_true + cams_true[c, 3:]
        uvs = focal * Xc[:, :2] / Xc[:, 2:3]
        for p_i in range(Pn):
            ci_list.append(c)
            pi_list.append(p_i)
            obs_list.append(uvs[p_i] + rngb.randn(2) * 0.1)
    ci = np.asarray(ci_list, np.int32)
    pi_ = np.asarray(pi_list, np.int32)
    obs = np.stack(obs_list)
    cams_n = cams_true + rngb.randn(C, 6) * 0.01
    pts_n = pts_true + rngb.randn(Pn, 3) * 0.05

    ref, _ = bundle_adjust(
        BAProblem(
            jnp.asarray(cams_n), jnp.asarray(pts_n), jnp.asarray(ci),
            jnp.asarray(pi_), jnp.asarray(obs), focal,
        ),
        iters=5, lam=1e-3,
    )

    mesh_ba = mesh  # (frames=2P, rows=2, cols=1): frames axis crosses procs
    n = mesh_ba.size
    P_loc = Pn // n
    order = np.argsort(pi_, kind="stable")
    prob_s = BAProblem(
        jnp.asarray(cams_n), jnp.asarray(pts_n),
        jnp.asarray(ci[order]), jnp.asarray(pi_[order] % P_loc),
        jnp.asarray(obs[order]), focal,
    )
    ref_s, _ = sharded_bundle_adjust(prob_s, mesh_ba, iters=5, lam=1e-3)
    np.testing.assert_allclose(
        np.asarray(ref_s.cams), np.asarray(ref.cams), atol=1e-6
    )
    ref_pts = np.asarray(ref.points)
    checked_pts = 0
    for sp in ref_s.points.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(sp.data), ref_pts[sp.index], atol=1e-6
        )
        checked_pts += 1
    assert checked_pts >= 4, checked_pts

    # ---- distributed VISUAL-INERTIAL BA: same sharding (points over the
    # full mesh, psum across the wire), IMU factors replicated and added
    # after the reduction (slam/vi_ba.py). Deltas synthesized from the
    # closed-form ground-truth constraints (dR = R_i R_{i+1}^T etc. — what
    # preintegrate returns on a perfect log of this constant-velocity
    # trajectory). Oracle: the unsharded VI solver.
    from optical_flow_tpu.slam.vi_ba import (
        VIBAProblem,
        sharded_vi_bundle_adjust,
        vi_bundle_adjust,
    )

    T_int = 0.5
    g_w = np.asarray([0.0, -9.81, 0.0])
    centers_true = np.stack([-cams_true[c, 3:] for c in range(C)])
    v_true = np.tile((centers_true[1] - centers_true[0]) / T_int, (C, 1))
    dR = np.tile(np.eye(3), (C - 1, 1, 1))
    dv = np.tile(-g_w * T_int, (C - 1, 1))
    dp = np.stack(
        [
            centers_true[i + 1] - centers_true[i] - v_true[i] * T_int
            - 0.5 * g_w * T_int * T_int
            for i in range(C - 1)
        ]
    )
    states_n = np.concatenate(
        [cams_n, v_true + rngb.randn(C, 3) * 0.02], axis=-1
    )
    common = dict(
        dR=jnp.asarray(dR), dv=jnp.asarray(dv), dp=jnp.asarray(dp),
        interval_T=jnp.full((C - 1,), T_int), gravity=jnp.asarray(g_w),
        focal=focal,
    )
    vi_ref, _ = vi_bundle_adjust(
        VIBAProblem(
            states=jnp.asarray(states_n), points=jnp.asarray(pts_n),
            cam_idx=jnp.asarray(ci), pt_idx=jnp.asarray(pi_),
            obs=jnp.asarray(obs), **common,
        ),
        iters=5, lam=1e-3,
    )
    vi_s, _ = sharded_vi_bundle_adjust(
        VIBAProblem(
            states=jnp.asarray(states_n), points=jnp.asarray(pts_n),
            cam_idx=jnp.asarray(ci[order]),
            pt_idx=jnp.asarray(pi_[order] % P_loc),
            obs=jnp.asarray(obs[order]), **common,
        ),
        mesh_ba, iters=5, lam=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(vi_s.states), np.asarray(vi_ref.states), atol=1e-6
    )
    vi_pts = np.asarray(vi_ref.points)
    checked_vi = 0
    for sp in vi_s.points.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(sp.data), vi_pts[sp.index], atol=1e-6
        )
        checked_vi += 1
    assert checked_vi >= 4, checked_vi

    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
