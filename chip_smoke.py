#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which raises on failure:

1. identify the card (name and power limit from ``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source) and time the build;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes, and time both;
4. drive the main path — ``ParticipationController.solve_batched`` on a
   (500, 50) heterogeneous fleet in modes ``"ne"`` and ``"centralized"``,
   then ``poa_report`` — with the launch counters zeroed just before and
   read just after, and check the outputs (finite, shaped, the kernel path
   against the f64 path, the card against the CPU on a small fleet);
5. print the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

TF32 is switched off for matrix products (and cuDNN), so the float64/fp32
einsums of the kernel path run at full precision. Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

B_FLEET, N_NODES = 500, 50          # benchmarks/heterogeneous_sweep.py sizes
B_CHECK = 4                          # small fleet held against the CPU
H100_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
H100_FP32_FLOP_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _events_ms(run, count: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / count


def call_ms(fn, iters: int) -> float:
    """Mean time of an eager ``fn()`` call as a caller sees it (CUDA events
    around ``iters`` back-to-back calls, after a warm-up): the larger of
    the host's launch cost and the device's work."""
    import torch

    def run():
        for _ in range(iters):
            fn()                 # each result is dropped, as a caller would

    fn()
    torch.cuda.synchronize()
    return _events_ms(run, iters)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    launch cost is in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: library, tables, allocator
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    def run():
        for _ in range(replays):
            graph.replay()

    ms = _events_ms(run, calls * replays)
    del graph
    return ms


def poibin_bound_ms(b: int, n: int, with_loo: bool) -> tuple[float, str]:
    """Least time for one poibin_dft call at (B, N) on an H100 SXM.

    Bytes: the fp32 p matrix and the two (S, S) tables read once, the pmf
    (and the leave-one-out block) written once. Operations (fp32): the
    characteristic function (8 per factor), the inverse DFT (4 per table
    entry), the renormalisation (2 per entry) and the deconvolutions (3 per
    step) — all fixed by the shape, none data-dependent.
    """
    s = n + 1
    nbytes = 4 * (b * n + 2 * s * s + b * s + (b * n * s if with_loo else 0))
    ops = b * (8 * s * n + 4 * s * s + 2 * s + (3 * n * n if with_loo else 0))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def trace_short_solve(solve) -> dict | None:
    """Wall time of ``solve()`` without tracing, then its device activity
    under ``torch.profiler``; ``None`` when the trace holds no device
    events. The idle share is 1 - device busy time / untraced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sweeps = int(sol.iters.max())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    busy = sum(e.time_range.elapsed_us() for e in events) * 1e-6
    return {"sweeps": sweeps, "wall_s_per_sweep": wall / sweeps,
            "device_events_per_sweep": len(events) / sweeps,
            "busy_s_per_sweep": busy / sweeps, "idle_share": 1 - busy / wall}


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.asymmetric_batched import (
        P_MIN, poa_report, solve_heterogeneous, verify_equilibrium_batched)
    from repro_torch.core.controller import ParticipationController
    from repro_torch.core.duration import paper_duration_model
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import poibin_dft as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_s: dict[str, float] = {}

    # 1. the card -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    phase_s["build"] = time.perf_counter() - t0
    for name in build.sources():
        log = build.library_path(name).with_suffix(".so.log")
        print(f"build {name}: {built.get(name, 0.0):.1f} s "
              f"(wall {phase_s['build']:.1f} s)")
        if log.exists():
            print(log.read_text().strip())

    # 3. kernels against their plain versions on the card -------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    def check(label, p, with_loo, atol):
        got = pk.poibin_dft(p, with_loo=with_loo)
        want = ref.poibin_dft_ref(p.to(torch.float32), with_loo=with_loo)
        got = got if with_loo else (got,)
        want = want if with_loo else (want,)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != p.dtype or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: dtype {g.dtype} / non-finite")
        err = max(max_err(g, w) for g, w in zip(got, want))
        print(f"poibin_dft {label}: max |kernel - plain| = {err:.3e} "
              f"(atol {atol:g})")
        if not err <= atol:
            raise AssertionError(f"poibin_dft {label}: error {err} > {atol}")
        return err

    p_loo = torch.tensor(rng.uniform(0.0, 1.0, (3 * B_FLEET, N_NODES)),
                         device=dev)
    p_pmf = torch.tensor(rng.uniform(0.0, 1.0, (B_FLEET, N_NODES)),
                         device=dev)
    err_main = max(check("(1500, 50) f64 loo", p_loo, True, 1e-5),
                   check("(500, 50) f64 pmf", p_pmf, False, 1e-5),
                   check("(1500, 50) f32 loo", p_loo.float(), True, 1e-5))
    edge = torch.tensor(rng.uniform(0.0, 1.0, (13, 7)), device=dev)
    edge[0, 0], edge[0, 1] = 0.0, 1.0
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        for with_loo in (True, False):
            v = "loo" if with_loo else "pmf"
            check(f"(1, 1) {tag} {v}",
                  torch.full((1, 1), 0.3, dtype=dtype, device=dev),
                  with_loo, 2e-6)
            check(f"(13, 7) p00=0 p01=1 {tag} {v}", edge.to(dtype),
                  with_loo, 2e-6)
    check("(1, 1) p=1 f64 loo", torch.ones((1, 1), dtype=torch.float64,
                                           device=dev), True, 2e-6)
    # N = 64 needs more than 48 KB of shared memory per block (the opt-in
    # path); N = 160 needs more than the card's 227 KB and must be refused.
    check("(37, 64) f32 loo", torch.tensor(
        rng.uniform(0.0, 1.0, (37, 64)), dtype=torch.float32, device=dev),
        True, 1e-5)
    try:
        pk.poibin_dft(torch.full((2, 160), 0.5, device=dev))
    except ValueError as e:
        print(f"poibin_dft (2, 160): refused as expected ({e})")
    else:
        raise AssertionError("poibin_dft accepted N=160 (> 227 KB smem)")

    p32, p32_pmf = p_loo.float(), p_pmf.float()
    timing = {}
    for variant, x, with_loo in (("loo", p32, True), ("pmf", p32_pmf, False)):
        def kernel():
            return pk.poibin_dft(x, with_loo=with_loo)

        def plain():
            return ref.poibin_dft_ref(x, with_loo=with_loo)

        t = timing[variant] = {
            "shape": list(x.shape),
            "ms": device_ms(kernel), "plain_ms": device_ms(plain, calls=2),
            "call_ms": call_ms(kernel, 200), "plain_call_ms": call_ms(plain, 5)}
        t["bound_ms"], t["bound_by"] = poibin_bound_ms(*x.shape,
                                                       with_loo=with_loo)
        print(f"poibin_dft {variant} {tuple(x.shape)} fp32, device time: "
              f"kernel {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.1f}"
              f" us, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); "
              f"eager call: kernel {t['call_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_call_ms'] * 1e3:.1f} us [{card}]")
    phase_s["kernels"] = time.perf_counter() - t0

    # 4. the main path ------------------------------------------------------
    rng = np.random.default_rng(0)
    costs = rng.uniform(0.5, 12.0, (B_FLEET, N_NODES))
    gammas = rng.uniform(0.2, 1.0, (B_FLEET, N_NODES))
    dur = paper_duration_model()
    pk.reset_counts()
    ops.reset_dispatch_stats()
    launches: dict[str, int] = {}
    t_main = time.perf_counter()
    ctrl = ParticipationController(n_nodes=N_NODES, duration_model=dur,
                                   device="cuda")
    profiles = {}
    for mode in ("ne", "centralized"):
        before = pk.counts.launches
        t0 = time.perf_counter()
        profiles[mode] = ctrl.solve_batched(gammas, costs, mode=mode)
        torch.cuda.synchronize()
        phase_s[f"solve_batched[{mode}]"] = time.perf_counter() - t0
        launches[f"solve_batched[{mode}]"] = pk.counts.launches - before
    before = pk.counts.launches
    t0 = time.perf_counter()
    rep = poa_report(costs, gammas, dur, damping=0.6, max_iters=300,
                     device="cuda")
    torch.cuda.synchronize()
    phase_s["poa_report"] = time.perf_counter() - t0
    launches["poa_report"] = pk.counts.launches - before
    phase_s["main_path"] = time.perf_counter() - t_main
    main_launches, main_plain = pk.counts.launches, pk.counts.plain
    stats = ops.dispatch_stats()
    print(f"main path launches: {launches} (total {main_launches}); "
          f"dispatch {stats}")
    if main_launches <= 0:
        raise AssertionError("poibin_dft was not launched on the main path")
    if main_plain or any("ref" in by for by in stats.values()):
        raise AssertionError(f"plain version ran on the card: plain calls "
                             f"{main_plain}, dispatch {stats}")
    for mode, p in profiles.items():
        if tuple(p.shape) != (B_FLEET, N_NODES) or not p.is_cuda:
            raise AssertionError(f"{mode}: shape {tuple(p.shape)} on {p.device}")
        if not bool(torch.isfinite(p).all()) or not bool(
                ((p >= 0) & (p <= 1)).all()):
            raise AssertionError(f"{mode}: probabilities outside [0, 1]")
    fields = (rep.deviation, rep.ne_cost, rep.opt_cost, rep.poa, rep.opt_p,
              rep.solution.p)
    if not all(bool(torch.isfinite(x).all()) for x in fields):
        raise AssertionError("poa_report: non-finite output")
    if not bool((rep.poa >= 1.0 - 1e-6).all()):
        raise AssertionError("poa_report: PoA below 1")
    converged = float(rep.solution.converged.double().mean())
    certified = float((rep.deviation <= 1e-3).double().mean())
    q = torch.quantile(rep.poa, torch.tensor([0.0, 0.5, 0.9, 1.0],
                                             dtype=rep.poa.dtype, device=dev))
    poa_q = dict(zip(("min", "p50", "p90", "max"), q.tolist()))
    iters = rep.solution.iters
    print(f"poa_report (500, 50): converged {converged:.3f}, certified "
          f"(deviation <= 1e-3) {certified:.3f}, PoA {poa_q}, sweeps "
          f"max {int(iters.max())} mean {float(iters.double().mean()):.1f} "
          f"[{card}]")
    for k, v in phase_s.items():
        print(f"wall {k}: {v:.2f} s [{card}]")

    # the outputs against the port's own f64 path, on the card and the CPU
    t0 = time.perf_counter()
    k_dev = verify_equilibrium_batched(rep.solution.costs, rep.solution.gammas,
                                       dur, rep.solution.p, device="cuda")
    r_dev = verify_equilibrium_batched(rep.solution.costs, rep.solution.gammas,
                                       dur, rep.solution.p, backend="ref",
                                       device="cuda")
    dev_err = max_err(k_dev, r_dev)
    print(f"deviation kernel vs f64 path (500 fleets): {dev_err:.3e} "
          f"(atol 1e-5)")
    if not dev_err <= 1e-5:
        raise AssertionError(f"kernel-path deviation off by {dev_err}")
    # The f64 solve is the same arithmetic on both devices. The ne pick
    # compares fp32 kernel-path costs of starts that may have reached one
    # equilibrium, so the card's pick must be one of the CPU's three f64
    # starts exactly, and the CPU's own pick to ten times the GS tol (1e-5).
    small = slice(0, B_CHECK)
    sol_gpu = solve_heterogeneous(costs[small], gammas[small], dur,
                                  device="cuda")
    sol_cpu = solve_heterogeneous(costs[small], gammas[small], dur,
                                  device="cpu")
    solve_err = max_err(sol_gpu.p.cpu(), sol_cpu.p)
    if not (solve_err <= 1e-10
            and bool((sol_gpu.iters.cpu() == sol_cpu.iters).all())):
        raise AssertionError(f"solve differs card vs CPU: {solve_err}, "
                             f"iters {sol_gpu.iters} vs {sol_cpu.iters}")
    ctrl_cpu = ParticipationController(n_nodes=N_NODES, duration_model=dur,
                                       device="cpu")
    cpu_ne = ctrl_cpu.solve_batched(gammas[small], costs[small], mode="ne")
    ne_gpu = profiles["ne"][small].cpu()
    ne_err = max_err(ne_gpu, cpu_ne)
    starts = (0.5, P_MIN, 1.0)                 # the controller's ne starts
    p0 = torch.tensor(starts, dtype=torch.float64).repeat_interleave(
        B_CHECK)[:, None].expand(-1, N_NODES)
    cpu_starts = solve_heterogeneous(
        np.tile(costs[small], (len(starts), 1)),
        np.tile(gammas[small], (len(starts), 1)), dur, p0=p0,
        device="cpu").p.reshape(len(starts), B_CHECK, N_NODES)
    start_err = float((ne_gpu[None] - cpu_starts).abs().amax(dim=2)
                      .amin(dim=0).max())
    print(f"card vs CPU ({B_CHECK} fleets): solve profiles {solve_err:.3e} "
          f"(atol 1e-10, sweeps equal), ne pick vs nearest CPU start "
          f"{start_err:.3e} (atol 1e-10), ne profiles {ne_err:.3e} "
          f"(atol 1e-4)")
    if not (start_err <= 1e-10 and ne_err <= 1e-4):
        raise AssertionError(f"ne profiles differ card vs CPU: nearest "
                             f"start {start_err}, pick {ne_err}")
    phase_s["output_checks"] = time.perf_counter() - t0

    # where a sweep's time goes: the same short solve (3 sweeps of the
    # (500, 50) fleet) timed bare, then traced by torch.profiler for its
    # device activity (kernels, copies, fills)
    t0 = time.perf_counter()
    sweep_trace = trace_short_solve(
        lambda: solve_heterogeneous(costs, gammas, dur, max_iters=3,
                                    device="cuda"))
    phase_s["sweep_trace"] = time.perf_counter() - t0
    if sweep_trace is None:
        print("sweep trace: device time not measured (the profiler "
              "returned no device events)")
    else:
        print(f"sweep trace ({sweep_trace['sweeps']} sweeps of (500, 50), "
              f"per sweep): wall {sweep_trace['wall_s_per_sweep'] * 1e3:.1f}"
              f" ms, {sweep_trace['device_events_per_sweep']:.0f} device "
              f"activities, device busy "
              f"{sweep_trace['busy_s_per_sweep'] * 1e3:.2f} ms, idle share "
              f"{sweep_trace['idle_share']:.3f} [{card}]")

    # 5. result lines -------------------------------------------------------
    t = timing["loo"]
    kernels = [{
        "name": "poibin_dft", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/poibin_dft.cu",
        "replaces": "src/repro/kernels/poibin_dft.py:108",
        "launches": main_launches, "max_abs_err": err_main,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
