#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which raises on failure:

1. identify the card (name and power limit from ``nvidia-smi``);
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and time the builds;
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge shapes (for the model kernels also at
   phi4-mini's GQA and 200,064-word vocabulary), and time both and, where
   one exists, the library call computing the same function;
4. drive the game path — ``ParticipationController.solve_batched`` on a
   (500, 50) heterogeneous fleet in modes ``"ne"`` and ``"centralized"``,
   then ``poa_report`` — with the launch counters zeroed just before and
   read just after, and check the outputs (finite, shaped, the kernel path
   against the f64 path, the card against the CPU on a small fleet);
5. drive the campaign path — ``run_campaigns`` replaying phase 4's 500
   ``"ne"`` profiles through 50-round FedAvg campaigns of the synthetic MLP
   task, with churn, deadlines and two hardware tiers — with the counters
   zeroed just before and read just after; check the outputs, then run it
   again through the merge's plain version on the same draws and compare;
6. run a small campaign on the card and on the CPU from the same numpy
   draws and compare them;
7. drive the model path — a (2, 4) fleet solved in mode ``"ne"``, then
   ``run_campaigns`` of ``model_task`` on stablelm-3b at full width and 2 of
   its 32 layers (bf16, 256 tokens, B = 2 scenarios x N = 4 clients, 4
   rounds), every local step through ``flash_attention`` (once a layer)
   and ``fused_ce``, every round through ``fedavg_agg`` — with the counters
   zeroed just before and read just after; check the outputs, then run it
   again through the plain oracles (``backend="ref"``) on the same draws
   and compare;
8. print the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

TF32 is switched off for matrix products (and cuDNN), so the float64/fp32
einsums of the kernel path run at full precision. Without CUDA, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
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
P_MLP = 3258                         # synthetic_mlp_task() parameters
# benchmarks/heterogeneous_campaign.py:71-72, 87-91, with N = 50
CAMPAIGN = dict(n_clients=N_NODES, local_steps=1, batch_per_client=8,
                max_rounds=50, target_acc=0.73, seed=1)
LR = 0.15
TARGET_F32 = 0.7300000190734863     # float32(0.73), the tracker's target
ACC_STEP = 1 / 128                   # one validation sample
SMALL = dict(b=4, n=6, rounds=12)    # the card-vs-CPU campaign
H100_BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# the model path: stablelm-3b at full width, 2 of its 32 layers
MODEL_ARCH, MODEL_LAYERS, MODEL_SEQ, MODEL_VAL = "stablelm-3b", 2, 256, 16
MODEL_FLEET = (2, 4)                 # (B scenarios, N clients)
MODEL_FL = dict(n_clients=4, local_steps=1, batch_per_client=4,
                max_rounds=4, target_acc=0.99, seed=1)
MODEL_LR = 0.1
MODEL_P = 416_179_200                # its parameters per replica
MODEL_TOL = 3e-2                     # tests/test_kernels.py:15, bf16


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


def fedavg_bound_ms(b: int, n: int, p: int, itemsize: int
                    ) -> tuple[float, str]:
    """Least time for one fedavg_agg call at (B, N, P) on an H100 SXM.

    Bytes: the client slab and the globals read once, the fp32 mask read
    once, the output written once. Operations: a multiply-add per client
    value and a division per output, 2 N P + P per scenario in fp32.
    """
    nbytes = itemsize * (b * n * p + 2 * b * p) + 4 * b * n
    ops = b * (2 * n * p + p)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _peak(dtype) -> float:
    import torch

    return H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else H100_FP32_FLOP_PER_S


def flash_bound_ms(b: int, s: int, h: int, kv: int, d: int, dtype,
                   causal: bool = True, window: int = 0
                   ) -> tuple[float, str]:
    """Least time for one flash_attention call on an H100 SXM.

    Bytes: q, k, v read once, the output written once. Operations: the
    two products over the (query, key) pairs the mask keeps, 4 D per pair
    (this run's mask: causal and window counted exactly), at the peak of
    the input type (bf16 tensor cores, or fp32 outside them).
    """
    import torch

    item = torch.finfo(dtype).bits // 8
    nbytes = item * (2 * b * s * h * d + 2 * b * s * kv * d)
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep &= i >= j
    if window > 0:
        keep &= (i - j) < window
    ops = 4 * b * h * d * int(keep.sum())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / _peak(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_ce_bound_ms(r: int, t: int, d: int, v: int, dtype
                      ) -> tuple[float, str]:
    """Least time for one fused_ce call on an H100 SXM.

    Bytes: hidden and W read once, int64 labels read once, the fp32 NLL
    written once. Operations: the logits' products, 2 d per logit, at the
    peak of the input type.
    """
    import torch

    item = torch.finfo(dtype).bits // 8
    nbytes = item * (r * t * d + r * d * v) + 8 * r * t + 4 * r * t
    ops = 2 * r * t * d * v
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / _peak(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch

    _, exp = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


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


def small_campaign(device: str):
    """A B = 4, N = 6, R = 12 campaign on ``device`` whose every random
    input — uniforms, initial parameters, client batches, validation
    batch — is made with numpy from one seed, so two devices see the same
    numbers (their generators differ)."""
    import numpy as np
    import torch

    from repro_torch.federated.campaign import (CampaignDraws, ChurnConfig,
                                                DeadlineConfig, run_campaigns)
    from repro_torch.federated.simulation import FLConfig
    from repro_torch.federated.tasks import synthetic_mlp_task
    from repro_torch.optim import sgd

    b, n, rounds = SMALL["b"], SMALL["n"], SMALL["rounds"]
    rng = np.random.default_rng(7)
    shape, d, hidden = (8, 8, 3), 192, 16
    templates = rng.standard_normal((10, *shape))

    def images(labels):
        return templates[labels] + 2.5 * rng.standard_normal(
            labels.shape + shape)

    labels = rng.integers(0, 10, (rounds, n, 1, 8))
    batches = {"images": images(labels), "labels": labels}
    val_labels = rng.integers(0, 10, (128,))
    val = {"images": images(val_labels), "labels": val_labels}
    params = {"w1": rng.standard_normal((b, d, hidden)) * d ** -0.5,
              "b1": np.zeros((b, hidden)),
              "w2": rng.standard_normal((b, hidden, 10)) * hidden ** -0.5,
              "b2": np.zeros((b, 10))}
    u = {k: rng.uniform(size=(b, rounds, n))
         for k in ("mask", "arrive", "depart", "late")}
    p = rng.uniform(0.3, 1.0, (b, n))

    dev = torch.device(device)
    batches = {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}
    task = dataclasses.replace(
        synthetic_mlp_task(device=dev),
        client_data=lambda cids, r, n_, steps: {
            k: v[r][list(cids)] for k, v in batches.items()},
        val_batch={k: torch.from_numpy(v).to(dev) for k, v in val.items()})
    draws = CampaignDraws.from_arrays(u["mask"], params, u["arrive"],
                                      u["depart"], u["late"], device=dev)
    fl = FLConfig(n_clients=n, local_steps=1, batch_per_client=8,
                  max_rounds=rounds, target_acc=0.73, seed=0)
    rates = (np.linspace(900.0, 1400.0, n)[None], np.full((1, n), 968.5))
    return run_campaigns(fl, *task.campaign_args(), sgd(LR), p,
                         energy_rates_j=rates,
                         churn=ChurnConfig(arrival=0.3, departure=0.1),
                         deadline=DeadlineConfig(miss=0.1), draws=draws,
                         device=dev)


def param_gaps(a, b):
    """Per-scenario max |a - b| over every parameter of two campaigns."""
    import torch

    return torch.stack([(a.params[k] - b.params[k]).abs().flatten(1).amax(1)
                        for k in a.params]).amax(0)


def explain_by_relu_flips(scenarios, fl, task, p, flags,
                          rounds_run) -> dict:
    """Why two campaigns that differ only in their merge's summation order
    drift past 2e-6 in ``scenarios``.

    Both runs are rerun on the same draws truncated to r = 1, 2, ...
    rounds. At the first r where a scenario's parameter gap exceeds 2e-6,
    the hidden pre-activations of round r - 1 (``x @ w1 + b1`` over every
    client's batch, from the global parameters each run held entering that
    round; one local step, so these are all of the round's ReLU inputs) are
    compared: a sign that differs between the runs is a ReLU kink crossed
    by a float32 rounding difference, after which the runs follow
    different branches of the same function. Returns ``{scenario: (round,
    sign flips, gap entering the round)}``.
    """
    from repro_torch.federated.campaign import (CampaignDraws,
                                                generator_draws,
                                                run_campaigns)
    from repro_torch.optim import sgd

    if not scenarios:
        return {}
    draws = generator_draws(fl, task.init_params, [fl.seed] * p.shape[0],
                            dtype=p.dtype, churn=True, deadline=True,
                            device=p.device)

    def truncated(r, backend):
        cut = CampaignDraws(mask=draws.mask[:, :r], params=draws.params,
                            arrive=draws.arrive[:, :r],
                            depart=draws.depart[:, :r],
                            late=draws.late[:, :r])
        return run_campaigns(dataclasses.replace(fl, max_rounds=r),
                             *task.campaign_args(), sgd(LR), p,
                             backend=backend, draws=cut, **flags)

    found, pending = {}, set(scenarios)
    entering = (draws.params, draws.params)
    for r in range(1, rounds_run + 1):
        runs = (truncated(r, "kernel"), truncated(r, "ref"))
        gaps = param_gaps(*runs)
        jumped = [b for b in sorted(pending) if gaps[b] > 2e-6]
        if jumped:
            images = task.client_data(range(fl.n_clients), r - 1,
                                      fl.batch_per_client,
                                      fl.local_steps)["images"]
            x = images.reshape(fl.n_clients, -1, images[0, 0, 0].numel())
            for b in jumped:
                pre = [x @ q["w1"][b] + q["b1"][b] for q in entering]
                flips = int(((pre[0] > 0) != (pre[1] > 0)).sum())
                gap_in = max(float((entering[0][k][b] - entering[1][k][b])
                                   .abs().max()) for k in entering[0])
                found[b] = (r - 1, flips, gap_in)
                pending.discard(b)
        if not pending:
            break
        entering = (runs[0].params, runs[1].params)
    return found


def trace_campaign(run, kernels=("fedavg_agg",), warm=True):
    """Wall time of a warm ``run()`` untraced, then its device activity
    under ``torch.profiler``: activities and busy time per round, the
    named kernels' device time per round, and the idle share (1 - busy /
    untraced wall) — ``None`` when the trace holds no device events.
    ``warm=False`` skips the warm-up call (the caller has run it).
    Returns that and the untraced run's result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = int(res.rounds.max())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, res
    busy = sum(e.time_range.elapsed_us() for e in events) * 1e-6
    per_kernel = {k: sum(e.time_range.elapsed_us() for e in events
                         if k in e.name) * 1e-3 / rounds for k in kernels}
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() * 1e-3 / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"rounds": rounds, "wall_s": wall, "wall_ms_per_round":
            wall / rounds * 1e3, "events_per_round": len(events) / rounds,
            "busy_ms_per_round": busy / rounds * 1e3,
            "kernel_ms_per_round": per_kernel, "top_ms_per_round": top,
            "idle_share": 1 - busy / wall}, res


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def main() -> int:
    import torch
    from torch.func import vmap

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.asymmetric_batched import (
        P_MIN, poa_report, solve_heterogeneous, verify_equilibrium_batched)
    from repro_torch.core.controller import ParticipationController
    from repro_torch.core.duration import paper_duration_model
    from repro_torch.core.energy import EnergyParams, per_node_energy_rates
    from repro_torch.federated.campaign import (PARAMS_STREAM, ChurnConfig,
                                                DeadlineConfig, run_campaigns)
    from repro_torch.federated.simulation import FLConfig
    from repro_torch.configs import get_config
    from repro_torch.federated.tasks import model_task, synthetic_mlp_task
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.registry import get_model
    from repro_torch.rng import generator
    from repro_torch.kernels import fedavg_agg as fk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as fc
    from repro_torch.kernels import poibin_dft as pk
    from repro_torch.optim import sgd

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

    # fedavg_agg at the campaign's shape (B, N, P) = (500, 50, 3258) and at
    # the edges; slabs made on the card from a seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def slab(b, n, p, dtype=torch.float64):
        g = torch.randn((b, p), generator=gen, device=dev, dtype=torch.float64)
        c = torch.randn((b, n, p), generator=gen, device=dev,
                        dtype=torch.float64)
        return g.to(dtype), c.to(dtype)

    def fcheck(label, g, c, m, atol):
        """atol None: within one bf16 ulp of the plain version."""
        got = fk.fedavg_agg(g, c, m)
        want = ref.fedavg_agg_ref(g, c, m)
        torch.cuda.synchronize()
        if got.dtype != g.dtype or got.shape != g.shape or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"fedavg_agg {label}: {got.dtype} "
                                 f"{tuple(got.shape)} / non-finite")
        err = max_err(got, want)
        if atol is None:
            ok = bool(((got.float() - want.float()).abs()
                       <= bf16_ulp(want)).all())
            bound = "one bf16 ulp"
        else:
            ok, bound = err <= atol, f"atol {atol:g}"
        empty = m.reshape(-1, m.shape[-1]).sum(-1) == 0
        rows_g = g.reshape(-1, g.shape[-1])
        fallback = bool(torch.equal(
            got.reshape(-1, g.shape[-1])[empty],
            rows_g[empty].float().to(g.dtype)))
        print(f"fedavg_agg {label}: max |kernel - plain| = {err:.3e} "
              f"({bound}); empty rows {int(empty.sum())}, previous global "
              f"through fp32 bitwise: {fallback}")
        if not (ok and fallback):
            raise AssertionError(f"fedavg_agg {label}: error {err}, "
                                 f"fallback {fallback}")
        return err

    g64, c64 = slab(B_FLEET, N_NODES, P_MLP)
    m01 = torch.rand((B_FLEET, N_NODES), generator=gen, device=dev) < 0.6
    err_fedavg = fcheck("(500, 50, 3258) f64 0/1 mask", g64, c64, m01, 2e-6)
    weights = m01 * torch.rand((B_FLEET, N_NODES), generator=gen,
                               device=dev) * 3.0
    fcheck("(500, 50, 3258) f64 weighted mask", g64, c64, weights, 2e-6)
    m_zero = m01.clone()
    m_zero[[3, 250, 499]] = False
    fcheck("(500, 50, 3258) f64, 3 all-zero rows", g64, c64, m_zero, 2e-6)
    c32, g32 = c64.float(), g64.float()
    fcheck("(500, 50, 3258) f32 0/1 mask", g32, c32, m_zero, 2e-6)
    c16, g16 = c64.bfloat16(), g64.bfloat16()
    fcheck("(500, 50, 3258) bf16 0/1 mask", g16, c16, m_zero, None)
    g1, c1 = slab(7, 1, P_MLP)
    m1 = torch.ones((7, 1), dtype=torch.bool, device=dev)
    m1[2] = False
    fcheck("(7, 1, 3258) f64 N=1", g1, c1, m1, 2e-6)
    gr, cr = slab(9, 13, 1001)
    mr = torch.rand((9, 13), generator=gen, device=dev) < 0.5
    mr[4] = False
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        fcheck(f"(9, 13, 1001) {tag} ragged P", gr.to(dtype), cr.to(dtype),
               mr, 2e-6)
    fcheck("(9, 13, 1001) bf16 ragged P", gr.bfloat16(), cr.bfloat16(), mr,
           None)
    fcheck("(1001,) unbatched f64", gr[0], cr[0], mr[0], 2e-6)

    m_lib = m01.to(torch.float64)[:, None, :]
    ft = {"shape": [B_FLEET, N_NODES, P_MLP],
          "ms": device_ms(lambda: fk.fedavg_agg(g64, c64, m01)),
          "plain_ms": device_ms(lambda: ref.fedavg_agg_ref(g64, c64, m01),
                                calls=2),
          "library_ms": device_ms(lambda: torch.bmm(m_lib, c64), calls=5),
          "call_ms": call_ms(lambda: fk.fedavg_agg(g64, c64, m01), 50),
          "plain_call_ms": call_ms(
              lambda: ref.fedavg_agg_ref(g64, c64, m01), 5),
          "f32_ms": device_ms(lambda: fk.fedavg_agg(g32, c32, m01)),
          "bf16_ms": device_ms(lambda: fk.fedavg_agg(g16, c16, m01))}
    ft["bound_ms"], ft["bound_by"] = fedavg_bound_ms(B_FLEET, N_NODES, P_MLP,
                                                     8)
    print(f"fedavg_agg (500, 50, 3258) f64, device time: kernel "
          f"{ft['ms'] * 1e3:.1f} us, plain {ft['plain_ms'] * 1e3:.1f} us, "
          f"library bmm {ft['library_ms'] * 1e3:.1f} us, bound "
          f"{ft['bound_ms'] * 1e3:.1f} us ({ft['bound_by']}); eager call: "
          f"kernel {ft['call_ms'] * 1e3:.1f} us, plain "
          f"{ft['plain_call_ms'] * 1e3:.1f} us; kernel on f32 / bf16 slabs "
          f"{ft['f32_ms'] * 1e3:.1f} / {ft['bf16_ms'] * 1e3:.1f} us (bounds "
          f"{fedavg_bound_ms(B_FLEET, N_NODES, P_MLP, 4)[0] * 1e3:.1f} / "
          f"{fedavg_bound_ms(B_FLEET, N_NODES, P_MLP, 2)[0] * 1e3:.1f} us)"
          f" [{card}]")
    del g64, c64, c32, g32, c16, g16, m_lib
    torch.cuda.empty_cache()

    # fedavg_agg at the model path's (2, 4, 416,179,200) bf16 slab
    g_m = torch.randn((MODEL_FLEET[0], MODEL_P), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    c_m = torch.randn((*MODEL_FLEET, MODEL_P), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    m_m = torch.tensor([[True, False, True, True], [False, False, False,
                                                    False]], device=dev)
    fcheck("(2, 4, 416179200) bf16 [model path], one empty row", g_m, c_m,
           m_m, None)
    fm = {"ms": device_ms(lambda: fk.fedavg_agg(g_m, c_m, m_m), calls=3,
                          replays=3),
          "call_ms": call_ms(lambda: fk.fedavg_agg(g_m, c_m, m_m), 3),
          "library_ms": device_ms(lambda: torch.bmm(
              m_m.to(torch.bfloat16)[:, None, :], c_m), calls=3, replays=3)}
    fm["bound_ms"], fm["bound_by"] = fedavg_bound_ms(*MODEL_FLEET, MODEL_P, 2)
    print(f"fedavg_agg (2, 4, 416179200) bf16, device time: kernel "
          f"{fm['ms']:.3f} ms, library bmm {fm['library_ms']:.3f} ms, bound "
          f"{fm['bound_ms']:.3f} ms ({fm['bound_by']}); eager call "
          f"{fm['call_ms']:.3f} ms [{card}]")
    del g_m, c_m
    torch.cuda.empty_cache()

    # flash_attention and fused_ce at the model path's shapes, at edge
    # shapes and at phi4-mini's; inputs made on the card from the seed
    bf16, fp32 = torch.bfloat16, torch.float32

    def rand(*shape, dtype=fp32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def within(label, got, want, tol):
        """tol None: within one bf16 ulp of the plain version plus 2e-5
        (both round an fp32 result to bf16, and the two fp32 results differ
        by ~1e-6, more than an ulp of an output near 0); else
        allclose(atol=rtol=tol)."""
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite output")
        err = max_err(got, want)
        if tol is None:
            ok = bool(((got.float() - want.float()).abs()
                       <= bf16_ulp(want) + 2e-5).all())
            bound = "one bf16 ulp + 2e-5"
        else:
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            bound = f"atol = rtol = {tol:g}"
        print(f"{label}: max |kernel - plain| = {err:.3e} ({bound})")
        if not ok:
            raise AssertionError(f"{label}: error {err} beyond {bound}")
        return err

    def qkv(b, s, h, kv, d, dtype):
        return rand(b, s, h, d, dtype=dtype), rand(b, s, kv, d, dtype=dtype), \
            rand(b, s, kv, d, dtype=dtype)

    def fa_check(label, shape, dtype, causal=True, window=0):
        q, k, v = qkv(*shape, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if got.dtype != dtype or got.shape != q.shape:
            raise AssertionError(f"flash_attention {label}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        return within(f"flash_attention {label}", got,
                      fa.plain(q, k, v, causal=causal, window=window),
                      None if dtype == bf16 else 2e-5)

    fa_main = (4 * MODEL_FLEET[0] * MODEL_FLEET[1], MODEL_SEQ, 32, 32, 80)
    fa_phi = (4, MODEL_SEQ, 24, 8, 128)
    err_flash = max(
        fa_check("(32, 256, 32/32, 80) bf16 causal [model path]", fa_main,
                 bf16),
        fa_check("(4, 256, 24/8, 128) bf16 causal [phi4-mini GQA]", fa_phi,
                 bf16))
    fa_check("(32, 256, 32/32, 80) fp32 causal", fa_main, fp32)
    fa_check("(3, 200, 4/2, 80) fp32 causal, ragged S", (3, 200, 4, 2, 80),
             fp32)
    fa_check("(2, 256, 8/8, 64) bf16 window 100", (2, 256, 8, 8, 64), bf16,
             window=100)
    fa_check("(2, 77, 4/1, 128) fp32 window 1, ragged S (each row keeps "
             "only itself; the padded rows of the last tile keep no key)",
             (2, 77, 4, 1, 128), fp32, window=1)
    fa_check("(2, 130, 4/4, 80) fp32 non-causal, ragged S",
             (2, 130, 4, 4, 80), fp32, causal=False)

    def ce_inputs(r, t, d, v, dtype):
        labels = torch.randint(0, v, (r, t), generator=gen, device=dev)
        return (rand(r, t, d, dtype=dtype),
                rand(r, d, v, dtype=dtype, scale=d ** -0.5), labels)

    def ce_check(label, h, w, labels):
        got = fc.fused_ce(h, w, labels)
        if got.dtype != fp32 or got.shape != labels.shape:
            raise AssertionError(f"fused_ce {label}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        return within(f"fused_ce {label}", got,
                      ref.fused_ce_ref(h, w, labels), 2e-5)

    ce_main = (MODEL_FLEET[0] * MODEL_FLEET[1], 4 * MODEL_SEQ, 2560, 50304)
    ce_phi = (1, 4 * MODEL_SEQ, 3072, 200_064)
    ce_m = ce_inputs(*ce_main, bf16)
    ce_p = ce_inputs(*ce_phi, bf16)
    err_ce = max(
        ce_check("(8, 1024, 2560) x (8, 2560, 50304) bf16 [model path]",
                 *ce_m),
        ce_check("(1, 1024, 3072) x (1, 3072, 200064) bf16 [phi4-mini]",
                 *ce_p))
    ce_check("(3, 100, 48) x (3, 48, 1000) fp32, ragged T and V",
             *ce_inputs(3, 100, 48, 1000, fp32))
    ce_check("(2, 70, 37) x (2, 37, 515) bf16, ragged T, V and d",
             *ce_inputs(2, 70, 37, 515, bf16))
    h1, w1, l1 = ce_inputs(1, 50, 64, 333, fp32)
    ce_check("(50, 64) x (64, 333) fp32, unbatched", h1[0], w1[0], l1[0])
    flat_w = rand(6, 48 * 1000 + 17, scale=48 ** -0.5)
    w_view = flat_w[:, :48_000].view(6, 48, 1000)   # read where it lies
    ce_check("(6, 64, 48) x (6, 48, 1000) fp32, W a strided slab view",
             rand(6, 64, 48), w_view,
             torch.randint(0, 1000, (6, 64), generator=gen, device=dev))
    del flat_w, w_view

    sdpa = torch.nn.functional.scaled_dot_product_attention
    model_timing = {}
    for name, shape in (("flash_attention", fa_main),
                        ("flash_attention phi4", fa_phi)):
        q, k, v = qkv(*shape, bf16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        gqa = shape[2] != shape[3]
        t = model_timing[name] = {
            "shape": list(shape),
            "ms": device_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: fa.plain(q, k, v), calls=2),
            "library_ms": device_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=gqa), calls=5),
            "call_ms": call_ms(lambda: fa.flash_attention(q, k, v), 20),
            "plain_call_ms": call_ms(lambda: fa.plain(q, k, v), 3)}
        t["bound_ms"], t["bound_by"] = flash_bound_ms(*shape, bf16)
    for name, (h, w, labels) in (("fused_ce", ce_m), ("fused_ce phi4", ce_p)):
        t = model_timing[name] = {
            "shape": [list(h.shape), list(w.shape)],
            "ms": device_ms(lambda: fc.fused_ce(h, w, labels), calls=2,
                            replays=3),
            "plain_ms": device_ms(lambda: ref.fused_ce_ref(h, w, labels),
                                  calls=1, replays=2),
            "library_ms": device_ms(lambda: torch.nn.functional.cross_entropy(
                torch.matmul(h, w).flatten(0, 1), labels.flatten(),
                reduction="none"), calls=2, replays=3),
            "call_ms": call_ms(lambda: fc.fused_ce(h, w, labels), 3),
            "plain_call_ms": call_ms(lambda: ref.fused_ce_ref(h, w, labels),
                                     1)}
        t["bound_ms"], t["bound_by"] = fused_ce_bound_ms(
            *h.shape, w.shape[-1], bf16)
    for name, t in model_timing.items():
        print(f"{name} {t['shape']} bf16, device time: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); eager call: kernel {t['call_ms']:.4f} ms,"
              f" plain {t['plain_call_ms']:.4f} ms [{card}]")
    del ce_m, ce_p
    torch.cuda.empty_cache()
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

    # 5. the campaign path -------------------------------------------------
    fl = FLConfig(**CAMPAIGN)
    task = synthetic_mlp_task(device="cuda")
    tiers = [EnergyParams(p_hw_w=150.0, t_train_s=6.0) if i < N_NODES // 2
             else EnergyParams() for i in range(N_NODES)]
    e_part, e_idle = per_node_energy_rates(tiers, device="cuda")
    flags = dict(energy_rates_j=(e_part[None], e_idle[None]),
                 churn=ChurnConfig(arrival=0.5, departure=0.02),
                 deadline=DeadlineConfig(miss=0.1), device="cuda")
    p_ne = profiles["ne"]
    pk.reset_counts()
    fk.reset_counts()
    ops.reset_dispatch_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    camp = run_campaigns(fl, *task.campaign_args(), sgd(LR), p_ne, **flags)
    torch.cuda.synchronize()
    phase_s["run_campaigns"] = time.perf_counter() - t0
    camp_launches, camp_plain = fk.counts.launches, fk.counts.plain
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = ops.dispatch_stats()
    rounds_run = int(camp.rounds.max())
    print(f"run_campaigns ({B_FLEET} scenarios, N = {N_NODES}, up to "
          f"{fl.max_rounds} rounds): wall "
          f"{phase_s['run_campaigns']:.2f} s, rounds run {rounds_run}, "
          f"fedavg_agg launches {camp_launches}, peak memory "
          f"{peak_gib:.2f} GiB; dispatch {stats} [{card}]")
    if camp_launches != rounds_run or camp_plain or pk.counts.plain or any(
            "ref" in by for by in stats.values()):
        raise AssertionError(f"campaign: {camp_launches} fedavg_agg launches "
                             f"for {rounds_run} rounds, plain calls "
                             f"{camp_plain}, dispatch {stats}")
    r_max = fl.max_rounds
    shapes = {"rounds": (B_FLEET,), "energy_wh": (B_FLEET,),
              "mean_aoi": (B_FLEET,), "participation_rate": (B_FLEET,),
              "acc_history": (B_FLEET, r_max), "k_history": (B_FLEET, r_max),
              "per_node_aoi": (B_FLEET, N_NODES),
              "straggler_counts": (B_FLEET, N_NODES),
              "present_counts": (B_FLEET, N_NODES)}
    for name, shape in shapes.items():
        x = getattr(camp, name)
        if tuple(x.shape) != shape or not x.is_cuda or not bool(
                torch.isfinite(x.double()).all()):
            raise AssertionError(f"campaign {name}: {tuple(x.shape)} on "
                                 f"{x.device} / non-finite")
    for k, v in camp.params.items():
        if v.shape[0] != B_FLEET or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"campaign params {k}: {tuple(v.shape)}")
    counts_ok = bool((camp.ledger.participation_counts
                      <= camp.rounds[:, None]).all()) and bool(
        (camp.ledger.rounds == camp.rounds).all())
    if not counts_ok:
        raise AssertionError("campaign: participation counts above rounds")
    rounds_f = camp.rounds.double()
    print(f"campaigns: converged {float(camp.converged.double().mean()):.3f},"
          f" rounds min {int(camp.rounds.min())} mean "
          f"{float(rounds_f.mean()):.2f} max {rounds_run}, energy "
          f"{float(camp.energy_wh.mean()):.2f} Wh mean, mean AoI "
          f"{float(camp.mean_aoi.mean()):.4f} rounds, participation "
          f"{float(camp.participation_rate.mean()):.4f}, stragglers "
          f"{int(camp.straggler_counts.sum())} [{card}]")

    # the same campaigns (same seeds, so the same draws) through the merge's
    # plain version: where the rounds agree, everything but the parameters
    # is equal bitwise; a scenario whose rounds differ must be a threshold
    # flip, its deciding accuracy one validation sample from the target
    t0 = time.perf_counter()
    camp_ref = run_campaigns(fl, *task.campaign_args(), sgd(LR), p_ne,
                             backend="ref", **flags)
    torch.cuda.synchronize()
    phase_s["run_campaigns[ref]"] = time.perf_counter() - t0
    same = camp.rounds == camp_ref.rounds
    pairs = {"k_history": (camp.k_history, camp_ref.k_history),
             "straggler_counts": (camp.straggler_counts,
                                  camp_ref.straggler_counts),
             "present_counts": (camp.present_counts, camp_ref.present_counts)}
    for obj, other, tag in ((camp.ledger, camp_ref.ledger, "ledger"),
                            (camp.aoi, camp_ref.aoi, "aoi")):
        for f in dataclasses.fields(obj):
            pairs[f"{tag}.{f.name}"] = (getattr(obj, f.name),
                                        getattr(other, f.name))
    unequal = [k for k, (a, b) in pairs.items()
               if not torch.equal(a[same], b[same])]
    gaps = param_gaps(camp, camp_ref)
    param_err = float(gaps[same].max())
    over = torch.nonzero(same & (gaps > 2e-6)).flatten().tolist()
    kinks = explain_by_relu_flips(over, fl, task, p_ne, flags, rounds_run)
    flips = []
    for b in torch.nonzero(~same).flatten().tolist():
        hit_k = camp.acc_history[b] >= TARGET_F32
        hit_r = camp_ref.acc_history[b] >= TARGET_F32
        r = int(torch.nonzero(hit_k != hit_r)[0])
        accs = (float(camp.acc_history[b, r]), float(camp_ref.acc_history[b, r]))
        flips.append((b, r, accs))
    bad_flips = [f for f in flips
                 if max(abs(a - TARGET_F32) for a in f[2]) > ACC_STEP]
    within = float(gaps[same & (gaps <= 2e-6)].max())
    print(f"kernel vs plain merge ({B_FLEET} campaigns, "
          f"{phase_s['run_campaigns[ref]']:.2f} s): rounds differ in "
          f"{len(flips)} {flips[:5]}; where equal: bitwise unequal fields "
          f"{unequal}; parameters within 2e-6 in "
          f"{int(same.sum()) - len(over)} scenarios (max {within:.3e}), "
          f"beyond it in {len(over)} (max {param_err:.3e}): {kinks}")
    unexplained = [b for b in over if kinks.get(b, (0, 0))[1] == 0]
    if unequal or unexplained or bad_flips:
        raise AssertionError(f"kernel vs plain merge: unequal {unequal}, "
                             f"parameter gaps beyond 2e-6 without a ReLU "
                             f"sign flip {unexplained}, non-threshold flips "
                             f"{bad_flips}")

    # where a campaign's time goes: the same call warm, timed bare, then
    # traced by torch.profiler for its device activity
    t0 = time.perf_counter()
    camp_trace, again = trace_campaign(
        lambda: run_campaigns(fl, *task.campaign_args(), sgd(LR), p_ne,
                              **flags))
    phase_s["campaign_trace"] = time.perf_counter() - t0
    rerun_equal = all(torch.equal(v, again.params[k])
                      for k, v in camp.params.items()) and torch.equal(
        camp.acc_history, again.acc_history)
    print(f"the same campaigns again through the kernel: parameters and "
          f"accuracies bitwise equal: {rerun_equal}")
    if not rerun_equal:
        raise AssertionError("run_campaigns is not deterministic")
    if camp_trace is None:
        print("campaign trace: device time not measured (the profiler "
              "returned no device events)")
    else:
        print(f"campaign trace ({camp_trace['rounds']} rounds of 500 "
              f"scenarios, warm): wall {camp_trace['wall_s']:.3f} s, per "
              f"round: wall {camp_trace['wall_ms_per_round']:.2f} ms, "
              f"{camp_trace['events_per_round']:.0f} device activities, "
              f"device busy {camp_trace['busy_ms_per_round']:.2f} ms, of it "
              f"fedavg_agg {camp_trace['kernel_ms_per_round']['fedavg_agg']:.3f}"
              f" ms; idle "
              f"share {camp_trace['idle_share']:.3f} [{card}]")

    # 6. card against CPU on replayed numpy draws ---------------------------
    t0 = time.perf_counter()
    small = {dev_name: small_campaign(dev_name)
             for dev_name in ("cuda", "cpu")}
    gpu, cpu = small["cuda"], small["cpu"]
    fields = {"rounds": (gpu.rounds, cpu.rounds),
              "k_history": (gpu.k_history, cpu.k_history),
              "acc_history": (gpu.acc_history, cpu.acc_history),
              "straggler_counts": (gpu.straggler_counts, cpu.straggler_counts),
              "present_counts": (gpu.present_counts, cpu.present_counts),
              "present_final": (gpu.present_final, cpu.present_final)}
    for obj, other, tag in ((gpu.ledger, cpu.ledger, "ledger"),
                            (gpu.aoi, cpu.aoi, "aoi")):
        for f in dataclasses.fields(obj):
            fields[f"{tag}.{f.name}"] = (getattr(obj, f.name),
                                         getattr(other, f.name))
    unequal = [k for k, (a, b) in fields.items() if not torch.equal(a.cpu(), b)]
    small_err = max(max_err(v.cpu(), cpu.params[k])
                    for k, v in gpu.params.items())
    phase_s["card_vs_cpu"] = time.perf_counter() - t0
    print(f"card vs CPU campaign (B = {SMALL['b']}, N = {SMALL['n']}, "
          f"R = {SMALL['rounds']}, numpy draws): rounds "
          f"{gpu.rounds.tolist()}, bitwise unequal fields {unequal}, "
          f"parameters {small_err:.3e}")
    if unequal:
        raise AssertionError(f"card vs CPU campaign: unequal {unequal}")
    for k, v in phase_s.items():
        if k in ("run_campaigns", "run_campaigns[ref]", "card_vs_cpu"):
            print(f"wall {k}: {v:.2f} s [{card}]")

    # 7. the model path -----------------------------------------------------
    # a (2, 4) fleet solved as in phase 4 (the paper's duration curve on
    # N = 4), then FedAvg campaigns of stablelm-3b clients at full width
    t0 = time.perf_counter()
    b_m, n_m = MODEL_FLEET
    rng = np.random.default_rng(1)
    costs_m = rng.uniform(0.5, 12.0, (b_m, n_m))
    gammas_m = rng.uniform(0.2, 1.0, (b_m, n_m))
    ctrl_m = ParticipationController(
        n_nodes=n_m, duration_model=dataclasses.replace(dur, n_nodes=n_m),
        device="cuda")
    p_model = ctrl_m.solve_batched(gammas_m, costs_m, mode="ne")
    torch.cuda.synchronize()
    phase_s["model_fleet"] = time.perf_counter() - t0
    cfg_m = dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_LAYERS)
    fl_m = FLConfig(**MODEL_FL)
    tasks_m = {backend: model_task(cfg_m, MODEL_SEQ, backend=backend,
                                   val_size=MODEL_VAL, device="cuda")
               for backend in ("kernel", "ref")}
    api_m = get_model(cfg_m)
    val_loss = vmap(api_m.loss, in_dims=(0, None))   # the plain path
    tokens_per_step = b_m * n_m * fl_m.batch_per_client * MODEL_SEQ

    def model_campaign(backend):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = run_campaigns(fl_m, *tasks_m[backend].campaign_args(),
                            sgd(MODEL_LR), p_model, device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    for m in (pk, fk, fa, fc):
        m.reset_counts()
    ops.reset_dispatch_stats()
    torch.cuda.reset_peak_memory_stats()
    camp_m, wall_m = model_campaign("kernel")
    model_launches = {"flash_attention": fa.counts.launches,
                      "fused_ce": fc.counts.launches,
                      "fedavg_agg": fk.counts.launches}
    plain_calls = [m.counts.plain for m in (pk, fk, fa, fc)]
    stats = ops.dispatch_stats()
    peak_m = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_s["run_campaigns[model]"] = wall_m
    rounds_m = int(camp_m.rounds.max())
    want_launches = {"flash_attention": MODEL_LAYERS * fl_m.local_steps
                     * fl_m.max_rounds,
                     "fused_ce": fl_m.local_steps * fl_m.max_rounds,
                     "fedavg_agg": fl_m.max_rounds}
    n_params = sum(v[0].numel() for v in camp_m.params.values())
    print(f"model path: {MODEL_ARCH} at full width (d_model "
          f"{cfg_m.d_model}, {cfg_m.n_heads} x {cfg_m.resolved_head_dim} "
          f"heads, d_ff {cfg_m.d_ff}, vocab {cfg_m.vocab}, "
          f"{cfg_m.param_dtype}), {MODEL_LAYERS} of 32 layers, "
          f"{n_params:,} parameters a replica, B = {b_m} x N = {n_m}, "
          f"{MODEL_SEQ} tokens, p {p_model.tolist()}; rounds run "
          f"{rounds_m}, launches {model_launches}, dispatch {stats}")
    if model_launches != want_launches or any(plain_calls) or any(
            "ref" in by for by in stats.values()):
        raise AssertionError(f"model path: launches {model_launches}, "
                             f"expected {want_launches}; plain calls "
                             f"{plain_calls}; dispatch {stats}")
    if n_params != MODEL_P or rounds_m != fl_m.max_rounds:
        raise AssertionError(f"model path: {n_params} parameters, "
                             f"{rounds_m} rounds")
    for name, shape in {"acc_history": (b_m, fl_m.max_rounds),
                        "energy_wh": (b_m,), "mean_aoi": (b_m,),
                        "k_history": (b_m, fl_m.max_rounds)}.items():
        x = getattr(camp_m, name)
        if tuple(x.shape) != shape or not bool(
                torch.isfinite(x.double()).all()):
            raise AssertionError(f"model campaign {name}: "
                                 f"{tuple(x.shape)} / non-finite")
    for k, v in camp_m.params.items():
        if v.dtype != torch.bfloat16 or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"model params {k}: {v.dtype} / non-finite")
    val_m = tasks_m["kernel"].val_batch
    loss_k = val_loss(camp_m.params, val_m)
    init_m = tasks_m["kernel"].init_params(generator(dev, fl_m.seed,
                                                     PARAMS_STREAM))
    loss_0 = float(api_m.loss(init_m, val_m))         # the shared start
    del init_m
    if not bool(torch.isfinite(loss_k).all()):
        raise AssertionError(f"model path: validation loss {loss_k}")
    print(f"model campaigns (kernel path): wall {wall_m:.2f} s, "
          f"{wall_m / rounds_m:.3f} s a round (the first round's warm-up "
          f"included), {tokens_per_step * fl_m.local_steps * rounds_m / wall_m:,.0f}"
          f" training tokens/s, peak memory {peak_m:.2f} GiB; accuracies "
          f"{camp_m.acc_history.tolist()}, energy "
          f"{camp_m.energy_wh.tolist()} Wh, mean AoI "
          f"{camp_m.mean_aoi.tolist()}, k {camp_m.k_history.tolist()}, "
          f"validation loss {loss_0:.4f} at the start, {loss_k.tolist()} "
          f"at the end (ln V = {np.log(cfg_m.vocab):.3f}) [{card}]")

    # the same campaigns (same seeds: the same draws and data) through the
    # plain oracles of both model kernels
    camp_r, wall_r = model_campaign("ref")
    phase_s["run_campaigns[model, ref]"] = wall_r
    pairs = {"rounds": (camp_m.rounds, camp_r.rounds),
             "k_history": (camp_m.k_history, camp_r.k_history)}
    for obj, other, tag in ((camp_m.ledger, camp_r.ledger, "ledger"),
                            (camp_m.aoi, camp_r.aoi, "aoi")):
        for f in dataclasses.fields(obj):
            pairs[f"{tag}.{f.name}"] = (getattr(obj, f.name),
                                        getattr(other, f.name))
    unequal = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    loss_r = val_loss(camp_r.params, val_m)
    gaps_m = {k: float((v.float() - camp_r.params[k].float()).abs().max())
              for k, v in camp_m.params.items()}
    worst = max(gaps_m, key=gaps_m.get)
    moved = sum(int((v != camp_r.params[k]).sum())
                for k, v in camp_m.params.items())
    a_w, b_w = camp_m.params[worst].float(), camp_r.params[worst].float()
    at = int((a_w - b_w).abs().argmax())
    pair = (float(a_w.flatten()[at]), float(b_w.flatten()[at]))
    ulps = gaps_m[worst] / float(bf16_ulp(torch.tensor(max(map(abs, pair)))))
    loss_gap = max_err(loss_k, loss_r)
    print(f"model path, kernel vs plain oracles (ref run {wall_r:.2f} s): "
          f"bitwise unequal fields {unequal}; accuracies "
          f"{camp_r.acc_history.tolist()}; parameters differ in {moved:,} "
          f"of {2 * MODEL_P:,} entries, max {gaps_m[worst]:.3e} at {worst} "
          f"({pair[0]:.6g} vs {pair[1]:.6g}: {ulps:.1f} bf16 ulps at that "
          f"magnitude; atol {MODEL_TOL}); validation loss "
          f"{loss_r.tolist()}, gap {loss_gap:.3e} (atol {MODEL_TOL})")
    if unequal or gaps_m[worst] > MODEL_TOL or loss_gap > MODEL_TOL:
        raise AssertionError(f"model path kernel vs ref: unequal {unequal},"
                             f" parameters {gaps_m[worst]}, loss {loss_gap}")

    # where a model round's time goes: one more kernel campaign, traced
    t0 = time.perf_counter()
    model_trace, _ = trace_campaign(
        lambda: model_campaign("kernel")[0], warm=False,
        kernels=("flash_attention", "fused_ce", "fedavg_agg"))
    phase_s["model_trace"] = time.perf_counter() - t0
    if model_trace is None:
        print("model trace: device time not measured (the profiler "
              "returned no device events)")
    else:
        print(f"model trace (one campaign of {rounds_m} rounds, warm): wall "
              f"{model_trace['wall_s']:.3f} s, per round: "
              f"{model_trace['events_per_round']:.0f} device activities, "
              f"device busy {model_trace['busy_ms_per_round']:.2f} ms, of it "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          model_trace["kernel_ms_per_round"].items())
              + f"; idle share {model_trace['idle_share']:.3f} [{card}]")
        print("model trace, the largest device activities per round: "
              + "; ".join(f"{name[:70]} {ms:.2f} ms" for name, ms in
                          model_trace["top_ms_per_round"]))
    for k in ("model_fleet", "run_campaigns[model]",
              "run_campaigns[model, ref]", "model_trace"):
        print(f"wall {k}: {phase_s[k]:.2f} s [{card}]")

    # 8. result lines -------------------------------------------------------
    t = timing["loo"]
    kernels = [{
        "name": "poibin_dft", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/poibin_dft.cu",
        "replaces": "src/repro/kernels/poibin_dft.py:108",
        "launches": main_launches, "max_abs_err": err_main,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }, {
        "name": "fedavg_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg.py:45",
        "launches": camp_launches + model_launches["fedavg_agg"],
        "max_abs_err": err_fedavg,
        "ms": ft["ms"], "plain_ms": ft["plain_ms"],
        "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
        "library_ms": ft["library_ms"],
    }]
    for name, src, line, err in (
            ("flash_attention", "flash_attention", 99, err_flash),
            ("fused_ce", "fused_ce", 77, err_ce)):
        t = model_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": model_launches[name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(f"launches by path: poibin_dft game {main_launches}; fedavg_agg "
          f"campaign {camp_launches}, model {model_launches['fedavg_agg']}; "
          f"flash_attention model {model_launches['flash_attention']}; "
          f"fused_ce model {model_launches['fused_ce']}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
