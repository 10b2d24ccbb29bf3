"""BASELINE config 5 as one composed flow (port of
plviwo_tpu/parallel/batch_replay.py):

    multi-sequence batch replay (sequence-sharded over the ranks)
      -> keyframe + landmark extraction from the estimated trajectories
      -> landmark-sharded Schur-complement BA refinement
      -> per-sequence ATE report (before / after BA).

Usage:
    python -m plviwo_tpu_torch.parallel.batch_replay --n-seq 4 --ranks 4 \
        --duration 12 [--device cpu] [--out report.json] [--scaling]

Each rank replays its shard of the sequences as a Python loop over the
frames of `fused_step_full` (JAX: one `lax.scan` over the sharded full
step), then the trajectories and accept counts are gathered.  Per sequence,
the rank that replayed it extracts the keyframes and the landmarks seen at
>= 3 keyframes, as JAX does, triangulates them from the estimated keyframe
poses and sends the problem to every rank; `ba.ba_refine` refines it over
all ranks.  Rank 0 returns JAX's report, keys and meaning unchanged, plus
the backend, the device, the replay's wall time, each sequence's BA time and
each rank's launches of each kernel in the replay.

Sequence construction: each sequence is an independent simulator run
(distinct seed).  The per-frame measurement batches are built on the host
with the harvest discipline of the live system (a track is used when lost
or when it reaches O observations; clone ring slots are the deterministic
`k % n_clones` of the step's timetable), so every measurement row is real
and geometrically consistent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64


def build_sequence_inputs(sim, t0, n_frames, cam_hz, n_clones, F, O, L,
                          imu_pad=24, wheel_pad=16):
    """Per-frame padded inputs of one sequence (host numpy, as JAX's)."""
    from ..ops import cam as cam_ops

    c = sim.cfg
    k_arr = torch.tensor(c.intrinsics, dtype=F64)
    dt_f = 1.0 / cam_hz
    times = t0 + dt_f * np.arange(1, n_frames + 1)
    imu_t, imu_w, imu_a = sim.imu_stream()

    def undistort(uv):
        return cam_ops.undistort(torch.as_tensor(uv), k_arr, 0).numpy()

    # --- point tracks: visibility runs harvested at loss or O obs ---
    frames_obs = []  # per frame: {fid: (uv, uvn)}
    for t in times:
        ids, uvs = sim.cam_frame(t)
        uvns = undistort(uvs) if len(ids) else np.zeros((0, 2))
        frames_obs.append(dict(zip(ids.tolist(), zip(uvs, uvns))))
    lines_obs = []
    for t in times:
        lids, segs = sim.line_frame(t)
        ep = segs.reshape(-1, 2) if len(lids) else np.zeros((0, 2))
        ep_n = undistort(ep) if len(lids) else ep
        lines_obs.append(dict(zip(lids.tolist(), zip(segs, ep_n.reshape(-1, 4)))))

    def harvest_runs(per_frame, O_cap):
        """[(harvest_frame, [(frame_idx, raw, norm), ...]), ...]"""
        runs, active = [], {}
        for k, obs in enumerate(per_frame):
            for fid in list(active):
                if fid not in obs:
                    if len(active[fid]) >= 3:
                        runs.append((k, active[fid]))
                    del active[fid]
            for fid, (raw, nrm) in obs.items():
                active.setdefault(fid, []).append((k, raw, nrm))
                if len(active[fid]) >= O_cap:
                    runs.append((k, active[fid]))
                    del active[fid]
        return runs

    dropped = 0

    def pack(runs, cap, width):
        nonlocal dropped
        uv = np.zeros((n_frames, cap, O, width))
        uvn = np.zeros((n_frames, cap, O, width))
        slot = np.zeros((n_frames, cap, O), dtype=np.int32)
        valid = np.zeros((n_frames, cap, O), dtype=bool)
        fill = np.zeros(n_frames, dtype=np.int32)
        for k, run in runs:
            i = fill[k]
            if i >= cap:
                dropped += 1
                continue
            for j, (fk, raw, nrm) in enumerate(run[:O]):
                uv[k, i, j] = raw
                uvn[k, i, j] = nrm
                slot[k, i, j] = fk % n_clones
                valid[k, i, j] = True
            fill[k] += 1
        return uv, uvn, slot, valid

    obs_uv, obs_uvn, obs_slot, obs_valid = pack(harvest_runs(frames_obs, O), F, 2)
    l_uv, l_uvn, l_slot, l_valid = pack(harvest_runs(lines_obs, O), L, 4)

    # --- IMU windows + wheel stacks per frame ---
    it = np.zeros((n_frames, imu_pad))
    iw = np.zeros((n_frames, imu_pad, 3))
    ia = np.zeros((n_frames, imu_pad, 3))
    for k, t in enumerate(times):
        t_prev = t - dt_f
        i0 = max(int(np.searchsorted(imu_t, t_prev)) - 1, 0)
        i1 = min(int(np.searchsorted(imu_t, t)) + 1, len(imu_t))
        sel_t = imu_t[i0:i1][:imu_pad]
        n = len(sel_t)
        it[k, :n] = sel_t
        it[k, n:] = sel_t[-1]
        iw[k, :n] = imu_w[i0:i1][:imu_pad]
        iw[k, n:] = imu_w[i1 - 1]
        ia[k, :n] = imu_a[i0:i1][:imu_pad]
        ia[k, n:] = imu_a[i1 - 1]

    wt = np.zeros((n_frames, wheel_pad))
    wm1 = np.zeros((n_frames, wheel_pad))
    wm2 = np.zeros((n_frames, wheel_pad))
    wvalid = np.zeros(n_frames, dtype=bool)
    for k, t in enumerate(times):
        ts = np.linspace(t - dt_f, t, wheel_pad // 2)
        for i, ti in enumerate(ts):
            wm1[k, i], wm2[k, i] = sim.wheel_sample(ti)
        wt[k, : len(ts)] = ts
        wt[k, len(ts):] = ts[-1]
        wm1[k, len(ts):] = wm1[k, len(ts) - 1]
        wm2[k, len(ts):] = wm2[k, len(ts) - 1]
        wvalid[k] = k > 0  # first interval predates the first clone

    return {"times": times, "obs_uv": obs_uv, "obs_uvn": obs_uvn,
            "obs_slot": obs_slot, "obs_valid": obs_valid,
            "line_uv": l_uv, "line_uvn": l_uvn, "line_slot": l_slot,
            "line_valid": l_valid, "imu_t": it, "imu_w": iw, "imu_a": ia,
            "wheel_t": wt, "wheel_m1": wm1, "wheel_m2": wm2,
            "wheel_valid": wvalid, "dropped": int(dropped),
            "frames_obs": frames_obs}


def seed_state(sim, layout, t0) -> dict:
    """Ground-truth-seeded filter state of one sequence, as a dict of numpy
    arrays with the JAX FilterState's unbatched shapes (for
    `FilterState.from_numpy`).  Unlike `examples.seed_state` it leaves the
    wheel extrinsics (wheel_q, wheel_p) at their defaults, as JAX's does."""
    from ..core.state import make_state
    from ..ops import lie

    c = sim.cfg
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-5, "imu_v": 1e-2,
                                    "imu_bg": 1e-3, "imu_ba": 1e-2},
                    device="cpu").to_numpy()
    kin = sim.gt_kin(t0)
    q = lie.rot_2_quat(torch.as_tensor(kin["R_GtoI"], dtype=F64)).numpy()
    p = np.asarray(kin["p_IinG"], dtype=np.float64)
    v = np.asarray(kin["v_IinG"], dtype=np.float64)
    i0 = int(np.searchsorted(sim.imu_t, t0))
    bg = np.asarray(sim.bg_true[min(i0, len(sim.bg_true) - 1)], dtype=np.float64)
    ba = np.asarray(sim.ba_true[min(i0, len(sim.ba_true) - 1)], dtype=np.float64)
    st.update(time=np.array(t0, dtype=np.float64), q=q, p=p, v=v, bg=bg, ba=ba,
              q_fej=q, p_fej=p, v_fej=v, bg_fej=bg, ba_fej=ba,
              wheel_k=np.array([c.wheel_rl, c.wheel_rr, c.wheel_base], dtype=np.float64))
    st["cam_k"][0] = c.intrinsics
    st["cam_q"][0] = c.cam_ext_q
    st["cam_p"][0] = c.cam_ext_p
    return st


def _ba_problem(sim, seq, traj_q, traj_p, n_frames, kf_stride, world, cfg0):
    """Sequence s's ATE before BA and its BA problem, as JAX builds them:
    keyframes every kf_stride frames, landmarks seen at >= 3 keyframes
    (their first 10 keyframe observations), triangulated from the estimated
    keyframe poses.  traj_q / traj_p (T,4) / (T,3) numpy."""
    from ..update import cam_helper

    times = seq["times"]
    gt = np.stack([np.asarray(sim.gt_kin(t)["p_IinG"]) for t in times])
    ate_before = float(np.sqrt(np.mean(np.linalg.norm(traj_p - gt, axis=1) ** 2)))
    kf_idx = np.arange(0, n_frames, kf_stride)
    seen = {}
    for ki, fk in enumerate(kf_idx):
        for fid, (raw, nrm) in seq["frames_obs"][fk].items():
            seen.setdefault(fid, []).append((ki, nrm))
    lm_ids = [fid for fid, v in seen.items() if len(v) >= 3]
    # the landmark axis pads to a multiple of the ranks (JAX's count)
    out = {"ate_before_m": ate_before, "n_landmarks": -(-len(lm_ids) // world) * world}
    if len(lm_ids) < 8:
        return out
    O_ba = 10
    obs_k = np.zeros((len(lm_ids), O_ba), dtype=np.int64)
    obs_uvn = np.zeros((len(lm_ids), O_ba, 2))
    obs_mask = np.zeros((len(lm_ids), O_ba), dtype=bool)
    for i, fid in enumerate(lm_ids):
        for j, (ki, nrm) in enumerate(seen[fid][:O_ba]):
            obs_k[i, j] = ki
            obs_uvn[i, j] = nrm
            obs_mask[i, j] = True
    cq = torch.tensor(cfg0.cam_ext_q, dtype=F64)
    cp = torch.tensor(cfg0.cam_ext_p, dtype=F64)
    lms0, ok, _ = cam_helper.triangulate_batch(
        torch.as_tensor(obs_uvn)[None], torch.as_tensor(traj_q[kf_idx[obs_k]])[None],
        torch.as_tensor(traj_p[kf_idx[obs_k]])[None], torch.as_tensor(obs_mask)[None],
        cq[None], cp[None])
    out.update(kf_idx=kf_idx, gt_kf=gt[kf_idx], lms0=lms0[0].numpy(), obs_k=obs_k,
               obs_uvn=obs_uvn, obs_mask=obs_mask & ok[0].numpy()[:, None],
               ate_before_kf_m=float(np.sqrt(np.mean(
                   np.linalg.norm(traj_p[kf_idx] - gt[kf_idx], axis=1) ** 2))))
    return out


def replay_rank(n_seq=4, duration=12.0, cam_hz=10.0, n_clones=11, F=32, O=8, L=12,
                kf_stride=3, ba_iters=5, seed0=10, *, group):
    """One rank's part of the composed flow (every rank of `group` calls it).
    Returns (rank 0's report or None, the whole batch's estimated positions
    (n_seq, n_frames, 3) on every rank)."""
    from ..core.layout import StateLayout
    from ..core.state import FilterState
    from ..sim.simulator import SimConfig, Simulator
    from . import ba as ba_mod
    from .replay import (CAM_DTYPE, KERNELS, batched_full_step, gather_rows, kernel_launches,
                         shard_slice, step_no_lone, zero_launches)

    dev = group.device
    t0 = 1.0
    n_frames = int((duration - t0) * cam_hz) - 1
    layout = StateLayout(n_clones=n_clones, n_cams=1, use_wheel=True)
    mine = shard_slice(group, n_seq)
    n_mine = mine.stop - mine.start

    def config(s):
        return SimConfig(duration=duration, seed=seed0 + s, n_pts=45, sigma_pix=0.8)

    sims = {s: Simulator(config(s)) for s in range(mine.start, mine.stop)}
    seqs = {s: build_sequence_inputs(sims[s], t0, n_frames, cam_hz, n_clones, F, O, L)
            for s in sims}
    dropped = sum(q["dropped"] for q in seqs.values())
    if dropped:
        print(f"[batch_replay] rank {group.rank}: capacity-dropped tracks: {dropped}",
              file=sys.stderr)

    def stack(key, dtype):
        return torch.as_tensor(np.stack([seqs[s][key] for s in sims], axis=1)).to(dev, dtype)

    keys = (("imu_t", F64), ("imu_w", F64), ("imu_a", F64), ("times", F64),
            ("obs_uv", F64), ("obs_uvn", F64), ("obs_slot", torch.int64),
            ("obs_valid", torch.bool), ("line_uv", F64), ("line_uvn", F64),
            ("line_slot", torch.int64), ("line_valid", torch.bool), ("wheel_t", F64),
            ("wheel_m1", F64), ("wheel_m2", F64), ("wheel_valid", torch.bool))
    frames = [stack(k, dt) for k, dt in keys]  # (T, B_mine, ...)
    state = FilterState.from_numpy([seed_state(sims[s], layout, t0) for s in sims], layout, dev)
    cfg0 = config(0)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=F64, device=dev)
    sigmas = (cfg0.sigma_w, cfg0.sigma_a, cfg0.sigma_wb, cfg0.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    zero_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_replay = time.perf_counter()
    traj_q, traj_p = [], []
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    for k in range(n_frames):
        state, m = step_no_lone(
            batched_full_step, 17, state, *(x[k] for x in frames), gravity, sigmas, 1.2, 6.0,
            2.0, wheel_noise, model=0, window_size=0.95 * n_clones / cam_hz,
            cam_dtype=CAM_DTYPE)
        traj_q.append(state.q)
        traj_p.append(state.p)
        counts += torch.stack([m["accepted"].sum(), m["lines_accepted"].sum()])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    replay_s = time.perf_counter() - t_replay
    launches = kernel_launches()
    launches = torch.tensor([[launches[k] for k in KERNELS]], dtype=torch.int64, device=dev)

    # whole batch on every rank: (B, T, .) trajectories, summed counts
    traj_q = gather_rows(group, torch.stack(traj_q, 1)).cpu().numpy()
    traj_p = gather_rows(group, torch.stack(traj_p, 1)).cpu().numpy()
    dist.all_reduce(counts)
    launches = [dict(zip(KERNELS, row)) for row in gather_rows(group, launches).tolist()]
    accepted, lines_accepted = (int(c) for c in counts)
    if accepted <= 0:
        raise RuntimeError("batch replay accepted no features")

    report = {"n_seq": n_seq, "n_frames": n_frames, "devices": group.world,
              "accepted": accepted, "lines_accepted": lines_accepted, "sequences": [],
              "backend": group.backend, "device": str(dev), "replay_s": replay_s,
              "launches_per_rank": launches}
    cq, cp = np.asarray(cfg0.cam_ext_q), np.asarray(cfg0.cam_ext_p)
    for s in range(n_seq):
        owner = s // n_mine
        problem = [_ba_problem(sims[s], seqs[s], traj_q[s], traj_p[s], n_frames, kf_stride,
                               group.world, cfg0) if owner == group.rank else None]
        dist.broadcast_object_list(problem, src=owner)
        pb = problem[0]
        if "lms0" not in pb:
            report["sequences"].append({"ate_before_m": pb["ate_before_m"],
                                        "ate_after_m": None, "note": "too few BA landmarks"})
            continue
        kf_idx = pb["kf_idx"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_ba = time.perf_counter()
        _, pp2, _, info = ba_mod.ba_refine(
            traj_q[s][kf_idx], traj_p[s][kf_idx], pb["lms0"], pb["obs_k"], pb["obs_uvn"],
            pb["obs_mask"], cq, cp, group=group, iters=ba_iters)
        pp2 = pp2.cpu().numpy()  # waits for the BA
        ba_ms = 1e3 * (time.perf_counter() - t_ba)
        # BA is gauge-fixed at keyframe 0: compare in that gauge
        ate_after = float(np.sqrt(np.mean(np.linalg.norm(pp2 - pb["gt_kf"], axis=1) ** 2)))
        report["sequences"].append({
            "ate_before_m": pb["ate_before_m"],
            "ate_before_kf_m": pb["ate_before_kf_m"],
            "ate_after_m": ate_after,
            "n_keyframes": int(len(kf_idx)), "n_landmarks": int(pb["n_landmarks"]),
            "ba_gain": [float(g) for g in info["gain"].cpu().numpy()],
            "ba_ms": ba_ms,
        })
    return (report if group.rank == 0 else None), traj_p


def run_batch_replay(n_seq=4, ranks=1, duration=12.0, cam_hz=10.0, n_clones=11, F=32, O=8,
                     L=12, kf_stride=3, ba_iters=5, seed0=10, device="cuda",
                     timeout: float = 900.0):
    """The composed flow over `ranks` ranks (n_seq must divide by it).
    Returns rank 0's report dict."""
    from .replay import run_ranks

    kw = dict(n_seq=n_seq, duration=duration, cam_hz=cam_hz, n_clones=n_clones, F=F, O=O,
              L=L, kf_stride=kf_stride, ba_iters=ba_iters, seed0=seed0)
    return run_ranks(replay_rank, ranks, kwargs=kw, device=device, timeout=timeout)[0][0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="BASELINE config 5 driver")
    ap.add_argument("--n-seq", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--scaling", action="store_true",
                    help="append a 1/2/4/...-rank scaling measurement up to --ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    report = run_batch_replay(n_seq=args.n_seq, ranks=args.ranks, duration=args.duration,
                              device=args.device)
    if args.scaling:
        from .scaling import measure, shared_note

        rows, n = [], 1
        while n <= args.ranks:
            fps, backend = measure(n, device=args.device)
            rows.append({"devices": n, "fps": fps, "backend": backend})
            n *= 2
        for row in rows:
            # ranks that share one card or the host's cores: total fps staying
            # about flat as ranks grow is the healthy signature (compute
            # conserved, sharding overhead bounded)
            row["total_vs_1dev"] = row["fps"] / rows[0]["fps"]
        report["scaling"] = {"note": shared_note(args.device, args.ranks), "rows": rows}
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
