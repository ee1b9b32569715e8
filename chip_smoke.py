#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's main path through its entry point at the paper's
Netflix scale (n = 17,770 items, m = 480,189 users, d = 100, synthetic
MF-like factors from ``--seed``): ``RkMIPSEngine("sah").build(...)`` on
the card, then ``query_batch`` at k = 10 and k = 50 over queries drawn
from the top 2% of items by norm (the titles a service would promote;
from the top 20% no user at this scale has a query in its top 50, and
the item scan never runs). It

  1. prints the card (``nvidia-smi`` name and power limit) and versions;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. runs the main path with every launch count set to 0 just before,
     and fails unless every kernel launched;
  4. holds the answers against the exact oracle: recall must be 1.0 but
     for misses that lie within float32 rounding of their threshold;
  5. holds each kernel against its plain PyTorch version on the inputs
     the main path gives it (Hamming exactly; SRP bits up to flips whose
     score lies within the rounding bound of 0);
  6. times each kernel and its plain version on the device (launches
     replayed from a CUDA graph) and each wrapper call from Python;
  7. splits one query batch into plan and execute, and profiles it for
     the device's busy share and its top kernels.

Any failure raises and exits nonzero. Without a CUDA device, or away from
the repository, it exits nonzero before printing any result. The last
line is the device JSON; the line before it names the card; the one
before that is the per-kernel JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# An SM issues INT32 work on half as many lanes as FP32 work.
INT32_OP_PER_S = FP32_FLOP_PER_S / 2

NQ = 16              # promoted items per query batch
TOP_FRAC = 0.02      # queries come from this top share of items by norm
ITERS = 200          # timed launches per kernel


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def call_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call of ``fn`` called from Python ``iters`` times, by
    CUDA events after ``warmup`` calls: what a host loop pays per call,
    wrapper and launch included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def srp_flip_check(x, proj, got, want):
    """Compare packed SRP codes bit by bit. Every differing bit must have a
    float64 score within 8 * d * 2**-24 * sum_i |x_i p_i| of 0. Returns
    (flips, max |bit difference|)."""
    import torch
    bits = lambda c: ((c.to(torch.int64)[:, :, None]
                       >> torch.arange(32, device=c.device)) & 1).reshape(
                           c.shape[0], -1)
    diff = bits(got) != bits(want)
    flips = int(diff.sum())
    if flips:
        rows, cols = torch.nonzero(diff, as_tuple=True)
        xr, pc = x[rows].double(), proj[:, cols].T.double()
        score = (xr * pc).sum(-1).abs()
        bound = 8 * x.shape[1] * 2.0 ** -24 * (xr * pc).abs().sum(-1)
        if bool((score > bound).any()):
            fail(f"srp_hash: {int((score > bound).sum())} of {flips} flipped "
                 f"bits lie outside the rounding bound")
    return flips, int(diff.any())


def profile_query(eng, queries, k: int) -> None:
    """Where one ``query_batch`` spends its time: the plan and execute
    phases on the host clock, and the device's busy share and top kernels
    from ``torch.profiler`` over a second run."""
    import torch
    from repro_torch.core import sah
    cfg = eng.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sah.rkmips_plan(eng.index, queries, k, tie_eps=cfg.tie_eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sah.rkmips_execute(eng.index, plan, k, n_cand=cfg.n_cand, scan=cfg.scan,
                       chunk=cfg.chunk)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"breakdown k={k}: plan {(t1 - t0) * 1e3:.1f} ms, execute "
          f"{(t2 - t1) * 1e3:.1f} ms ({plan.n_work} lanes)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.query_batch(queries, k)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue           # operator rows repeat their kernels' time
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: the profiler recorded no device time: not measured")
        return
    print(f"profile k={k} (profiler on): wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms = {busy / wall_us:.1%}, idle "
          f"{1 - busy / wall_us:.1%}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {dev_us / 1e3:9.2f} ms  {count:7d} x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic data and the build's draws")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import RkMIPSEngine, get_config
    from repro_torch.core import exact, metrics, sa_alsh, sah
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- build the kernels from the checkout's sources ---------------------
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s "
          f"({', '.join(_build.KERNELS)} -> {_build.BUILD_DIR.name}/)")

    # -- data at the paper's Netflix scale ---------------------------------
    ds = synthetic.PAPER_DATASETS["netflix"]
    cfg = get_config("sah")
    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(gen, ds.n_items, ds.m_users,
                                                 ds.d, device=dev)
    queries = synthetic.queries_from_items(gen, items, NQ,
                                           top_frac=TOP_FRAC)
    print(f"data: netflix n={ds.n_items} m={ds.m_users} d={ds.d} "
          f"nq={NQ} from the top {TOP_FRAC:.0%} by norm, "
          f"seed={args.seed}; config sah {cfg}")

    # -- the main path, counted ---------------------------------------------
    ops.reset_launch_counts()
    eng = RkMIPSEngine(cfg).build(items, users, gen)
    after_build = dict(ops.launch_counts)
    results = {}
    for k in (10, 50):
        before = dict(ops.launch_counts)
        res = eng.query_batch(queries, k)
        results[k] = res
        ham = ops.launch_counts["hamming_scores"] - before["hamming_scores"]
        chunks = ops.launch_counts["srp_hash"] - before["srp_hash"]
        print(f"query k={k}: {res.seconds * 1e3 / NQ:.3f} ms/query "
              f"({res.seconds:.3f} s for {NQ}); host loop: {chunks} "
              f"chunks, {ham} tile steps")
        print(f"  funnel: {res.funnel.format()}")
    launches = dict(ops.launch_counts)
    idx = eng.index
    print(f"build: {eng.build_seconds:.3f} s (partitions="
          f"{int(idx.alsh.n_parts)}, cone blocks={idx.n_blocks}, "
          f"m_pad={idx.n_users}, item tiles={idx.alsh.tile_max_norm.numel()})"
          f"; launches in build {after_build}")
    print(f"launch_counts (main path): {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # -- answers against the exact oracle ------------------------------------
    users_unit = sah.unit_rows(users)
    for k, res in results.items():
        pred = res.predictions
        if pred.shape != (NQ, ds.m_users) or pred.dtype != torch.bool:
            fail(f"predictions have shape {tuple(pred.shape)} {pred.dtype}")
        truth = eng.oracle(queries, k)
        missed = torch.nonzero(truth & ~pred).tolist()
        ties = sum(exact.float_tie(items, users_unit[u], queries[q], k,
                                   cfg.tie_eps) for q, u in missed[:1000])
        if len(missed) > 1000 or ties != len(missed):
            fail(f"k={k}: {len(missed) - ties} missed users are not float "
                 f"ties")
        rec = metrics.recall(pred, truth)
        f1 = metrics.f1_score(pred, truth)
        print(f"oracle k={k}: recall min {float(rec.min()):.6f} mean "
              f"{float(rec.mean()):.6f}; F1 mean {float(f1.mean()):.4f} "
              f"min {float(f1.min()):.4f}; audience {int(truth.sum())} true "
              f"/ {int(pred.sum())} predicted; misses {len(missed)} "
              f"(all float ties: {ties})")

    # -- kernels against their plain versions, at main-path inputs -----------
    n_top = cfg.n_top or 2 * cfg.k_max
    split = sah.split_items_by_norm(items, n_top)
    prep = sa_alsh.prepare_items(split.rest, b=cfg.b,
                                 max_partitions=cfg.max_partitions,
                                 tile=cfg.tile, transform=cfg.transform)
    rows = prep.transformed.contiguous()
    proj = idx.alsh.proj
    codes_k = ops.srp_hash(rows, proj)
    if not torch.equal(codes_k, idx.alsh.codes):
        fail("srp_hash is not deterministic against the built index codes")
    flips_b, err_b = srp_flip_check(rows, proj, codes_k,
                                    ref.srp_hash(rows, proj))
    plan = sah.rkmips_plan(idx, queries, 10, tie_eps=cfg.tie_eps)
    lane_ids = plan.queue[:cfg.chunk] % idx.n_users
    chunk_users = idx.users[lane_ids].contiguous()
    qproj = proj[:-1]
    ucodes = ops.srp_hash(chunk_users, qproj)
    flips_q, err_q = srp_flip_check(chunk_users, qproj, ucodes,
                                    ref.srp_hash(chunk_users, qproj))
    tile_codes = idx.alsh.codes[:cfg.tile]
    ham_k = ops.hamming_scores(ucodes, tile_codes)
    ham_p = ref.hamming_scores(ucodes, tile_codes)
    ham_err = int((ham_k - ham_p).abs().max())
    if ham_err != 0:
        fail(f"hamming_scores differs from its plain version by {ham_err}")
    torch.cuda.synchronize()
    print(f"check srp_hash build rows {tuple(rows.shape)} x "
          f"{tuple(proj.shape)}: {flips_b} flipped bits, each with "
          f"|score| <= 8 * d * 2**-24 * sum_i |x_i p_i|")
    print(f"check srp_hash query chunk {tuple(chunk_users.shape)} x "
          f"{tuple(qproj.shape)}: {flips_q} flipped bits, each with "
          f"|score| <= 8 * d * 2**-24 * sum_i |x_i p_i|")
    print(f"check hamming_scores {tuple(ucodes.shape)} x "
          f"{tuple(tile_codes.shape)}: exact (max abs err 0)")

    # -- times -------------------------------------------------------------
    it = ITERS
    ham_ms = device_ms(lambda: ops.hamming_scores(ucodes, tile_codes), it)
    ham_plain = device_ms(lambda: ref.hamming_scores(ucodes, tile_codes), it)
    ham_call = call_ms(lambda: ops.hamming_scores(ucodes, tile_codes), it)
    srp_ms = device_ms(lambda: ops.srp_hash(chunk_users, qproj), it)
    srp_plain = device_ms(lambda: ref.srp_hash(chunk_users, qproj), 20)
    srp_call = call_ms(lambda: ops.srp_hash(chunk_users, qproj), it)
    srpb_ms = device_ms(lambda: ops.srp_hash(rows, proj), it)
    srpb_plain = device_ms(lambda: ref.srp_hash(rows, proj), 20)

    def bound(nbytes, ops_, rate):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / rate
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    c, w = ucodes.shape
    t = tile_codes.shape[0]
    ham_bound, ham_by = bound(4 * (c * w + t * w + c * t), 3 * c * t * w,
                              INT32_OP_PER_S)

    def srp_bound(x, p):
        (n, d), b = x.shape, p.shape[1]
        return bound(4 * (n * d + d * b + n * b // 32), 2 * n * d * b,
                     FP32_FLOP_PER_S)

    srp_bnd, srp_by = srp_bound(chunk_users, qproj)
    srpb_bnd, srpb_by = srp_bound(rows, proj)
    print(f"time hamming_scores {tuple(ucodes.shape)}x"
          f"{tuple(tile_codes.shape)}: kernel {ham_ms:.5f} ms (device), {ham_call:.5f} ms per call "
          f"from Python; plain {ham_plain:.5f} ms; bound {ham_bound:.6f} ms "
          f"({ham_by}); no single PyTorch call computes it")
    print(f"time srp_hash query chunk {tuple(chunk_users.shape)}: kernel "
          f"{srp_ms:.5f} ms (device), {srp_call:.5f} ms per call from "
          f"Python; plain {srp_plain:.5f} ms; bound {srp_bnd:.6f} ms "
          f"({srp_by}); no single PyTorch call computes it")
    print(f"time srp_hash build rows {tuple(rows.shape)}: kernel "
          f"{srpb_ms:.5f} ms, plain {srpb_plain:.5f} ms, bound "
          f"{srpb_bnd:.6f} ms ({srpb_by})")
    profile_query(eng, queries, 10)
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [
        {"name": "srp_hash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/srp_hash.cu",
         "replaces": "src/repro/kernels/srp_hash.py:41",
         "launches": launches["srp_hash"], "max_abs_err": err_q,
         "ms": srp_ms, "plain_ms": srp_plain, "bound_ms": srp_bnd,
         "bound_by": srp_by, "library_ms": None, "call_ms": srp_call,
         "shape": f"{tuple(chunk_users.shape)}x{tuple(qproj.shape)}",
         "flips": flips_q, "build_shape_ms": srpb_ms,
         "build_shape_bound_ms": srpb_bnd, "build_shape_flips": flips_b,
         "build_shape_max_abs_err": err_b},
        {"name": "hamming_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming_scan.cu",
         "replaces": "src/repro/kernels/hamming_scan.py:36",
         "launches": launches["hamming_scores"], "max_abs_err": ham_err,
         "ms": ham_ms, "plain_ms": ham_plain, "bound_ms": ham_bound,
         "bound_by": ham_by, "library_ms": None, "call_ms": ham_call,
         "shape": f"{tuple(ucodes.shape)}x{tuple(tile_codes.shape)}"},
    ]
    print(f"kernels: {json.dumps([k['name'] for k in kernels])}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
