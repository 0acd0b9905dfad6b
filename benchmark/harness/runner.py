"""One run of one cell: set-up, the window, the comparison, the result.

``main(argv)`` is ``benchmark/run.py``'s.  The cell's traffic mix names
its driver (``benchmark/drivers/<name>.py``): the adapter of the entry
point and the closed loop, which this module runs the same way for every
cell: warm-up, the window (``--trace 0``), or, with ``--trace 1``,
``traced_calls`` calls by the host clock alone and as many again under the
profiler.  A cell on one card runs in this one process; a cell on several
runs in one rank process a card (``harness.ranks``), each running the same
code with a ``ranks.Team`` and rank 0 judging and reporting.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

from harness import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "mcax")


def forbidden_modules(names=None) -> list:
    """Loaded modules (``names``: these) of JAX or of the JAX package, by
    whole top-level name (``mcax_torch`` is not ``mcax``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cell: dict
    config: dict
    traffic: dict
    calls: int
    samples: int                   # per-channel samples of the calls made
    window_s: float
    setup_s: float
    series: dict                   # the driver's per-call timings
    traces: Optional[list] = None  # a harness.trace.Trace a card
    cards: int = 1


def job_for(args, t_start: float) -> dict:
    return {"workload": args.workload, "seeds": [args.seed],
            "seconds": args.seconds, "trace": bool(args.trace),
            "t_start": t_start, "device": "cuda", "overrides": {},
            "inject": None}


def run_job(job: dict, team=None) -> list:
    """Run a cell in this process, once for each of ``job["seeds"]`` after
    one set-up, and return the result lines' objects (None on a rank other
    than 0 of ``team``, a ``ranks.Team``).  ``job["control"]`` puts the
    reference's control in the program's place, for as many calls as a run
    checks; ``job["inject"]`` (``module:function``) wraps the program's
    adapter; ``job["spec"]``, where given, stands for ``BENCHMARK.json``."""
    import torch
    from harness import program, ranks
    team = team or ranks.Team()

    bench = job.get("spec") or cells.spec()
    cell = cells.workload(bench, job["workload"])
    cfg = cells.config(cell["config"])
    traffic = {**cells.traffic(cell["traffic"]), **job["overrides"]}
    driver = cells.driver(traffic["driver"])
    dev = torch.device(job["device"])
    if job.get("control"):
        prog = cells.reference(cfg["reference"]).Control(cfg, dev)
    else:
        if dev.type == "cuda":
            program.load_kernels()
        prog = driver.make(cfg, dev)
    if job["inject"]:
        import importlib
        mod, fn = job["inject"].split(":")
        prog = getattr(importlib.import_module(mod), fn)(prog)
    return [one_seed(job, seed, bench, cell, cfg, traffic, driver, prog,
                     dev, team) for seed in job["seeds"]]


def one_seed(job, seed, bench, cell, cfg, traffic, driver, prog, dev, team
             ) -> Optional[dict]:
    import torch
    import scenes
    from harness import drive, trace as tr_mod
    limits = cells.limits(cell["name"])
    b, d = traffic["blocks_per_call"], traffic["distinct_calls"]
    c, length = cfg["config"]["array"]["num_mics"], cfg["config"]["block_len"]
    inputs = scenes.make(cfg, traffic, b * d, seed, dev).view(d, b, c,
                                                              length)
    if team.world > 1:
        # each rank made the scene on its own card: the same one
        team.same("scenes", scenes.digest(inputs))
    if dev.type == "cuda":
        # the peak read is the program's: its inputs resident, not the
        # scene's making
        torch.cuda.reset_peak_memory_stats(dev)
    checked = traffic["checked_calls"]
    # warm this cell's shapes and the allocator: as many calls, kept as
    # the window keeps its checked ones
    driver.run(prog, inputs, drive.Sampler(checked, seed), dev,
               calls=checked + 1)

    sampler = drive.Sampler(checked, seed)
    traces = None
    if job.get("control"):
        loop = driver.run(prog, inputs, sampler, dev, calls=checked + 1)
        series = loop.series
    elif job["trace"]:
        n = traffic["traced_calls"]
        # the host clock's per-call readings, away from the profiler's cost
        series = driver.run(prog, inputs, drive.Sampler(0, seed, False),
                            dev, calls=n).series
        holder = {}

        def traced():
            holder["loop"] = driver.run(prog, inputs, sampler, dev, calls=n)
        traces = [tr_mod.profiled(traced)]
        loop = holder["loop"]
    else:
        loop = driver.run(prog, inputs, sampler, dev,
                          seconds=job["seconds"])
        series = loop.series
    setup_s = loop.t0_wall - job["t_start"]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    # the fullest card's peak, every card's trace and the calls to judge
    # (a driver of several ranks gathers their outputs) on rank 0
    peak = max(team.gather(int(peak)))
    if traces is not None:
        traces = team.gather(traces[0])
    records = (driver.records(prog, sampler, team)
               if hasattr(driver, "records") else sampler.records())
    if team.rank != 0:
        return None
    numbers, failed = judge(cfg, limits, records, inputs, dev)
    run = Run(cell=cell, config=cfg, traffic=traffic, calls=loop.calls,
              samples=loop.calls * b * length, window_s=loop.window_s,
              setup_s=setup_s, series=series, traces=traces,
              cards=team.world)
    return result(bench, run, numbers, limits, failed, peak, dev)


def judge(cfg, limits, records, inputs, dev):
    """(the widest reading of each number over the checked calls, how many
    checked calls exceed a limit)."""
    from reference import common
    ref = cells.reference(cfg["reference"])
    chain = common.Chain(cfg, dev)
    worst, failed = {}, 0
    for rec in records:
        got = ref.judge(chain, {"x": inputs[rec["index"]], **rec})
        got.update(rec.get("numbers", {}))     # the driver's own, if any
        failed += any(v > limits[k] for k, v in got.items())
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, failed


def result(bench, run: Run, numbers, limits, failed, peak, dev):
    import torch
    trace = run.traces is not None
    metrics = {}
    for m in cells.metrics(bench, run.cell["name"], trace):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": run.cards, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0 and all(
               v <= limits[k] for k, v in numbers.items()),
           "attempted": run.calls, "failed": failed, "metrics": metrics,
           "device": device}
    if trace:
        from harness import trace as tr_mod
        device["busy_s"] = sum(t.busy_s() for t in run.traces) / len(
            run.traces)
        device["window_s"] = sum(t.window_s for t in run.traces) / len(
            run.traces)
        out["breakdown"] = tr_mod.breakdown(run.traces[0])
    out["compared"] = {k: {"value": v, "limit": limits[k]}
                       for k, v in sorted(numbers.items())}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch
    # one host thread for torch's own work: the program's is on the card,
    # and other threads on a shared host spread the block step's latency
    torch.set_num_threads(1)
    bench = cells.spec()
    cell = cells.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell["chips"] == 1:
        res = run_job(job_for(args, t_start))[0]
    else:
        from harness import ranks
        try:
            res = ranks.launch(job_for(args, t_start), cell["chips"])[0]
        except ranks.RanksFailed as e:
            print(f"{args.workload}: {e}", file=sys.stderr)
            return 1
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    import roofline
    print(roofline.card_line(), file=sys.stderr)
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0
