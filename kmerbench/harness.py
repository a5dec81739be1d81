"""One run of one cell: set-up, the measured window, the check, the
result line.

Set-up makes the corpus and the pool of query batches from the seed on
the device, builds the index through the port, and warms up every batch
once; the host seconds of each of its stages go to standard error. The window is a closed loop of one caller that keeps the mix's
``in_flight`` calls outstanding for ``seconds`` seconds and then waits for
the last of them; a uniform sample of the window's calls, drawn from the
seed, keeps its answers. Once the window has closed and the port's state
is freed, the reference works the counts out again from the reads and
every kept answer is compared with it.
"""

from __future__ import annotations

import collections
import random
import sys
import time
from dataclasses import dataclass, field

import torch

from kmerbench import trace as tracing
from kmerbench.corpus import make_corpus
from kmerbench.spec import Spec
from kmerbench.system import SYSTEMS
from kmerbench.traffic import hooks

#: calls of the window whose answers are kept and compared
SAMPLE_CALLS = 8
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "aindex_tpu")
#: the most that a compared number may read
LIMITS = {"mismatches": 0}


@dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    config: dict
    mix: dict
    spec: Spec
    setup_s: float = 0.0
    build_s: float = 0.0
    index_bytes: int | None = None
    window_s: float = 0.0
    calls: int = 0
    codes_answered: int = 0
    submit_s: float = 0.0
    #: calls of the window by pool batch
    batch_calls: list[int] = field(default_factory=list)
    pool_stats: list = field(default_factory=list)
    trace: tracing.TraceSummary | None = None
    device_kind: str | None = None


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds, each
    module's name compared whole up to its first dot."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class _Done:
    """A completion mark on the CPU, where every call has finished when it
    returns."""

    def synchronize(self) -> None:
        pass


def _mark(device: torch.device):
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device: torch.device) -> int | None:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else None


def _window(system, call, pool, in_flight: int, seconds: float, device, sampler,
            run: Run) -> None:
    """The measured loop. Keeps ``in_flight`` calls outstanding, each made
    by the mix's ``call``; a call's answers are complete when its mark is
    reached."""
    record = torch.profiler.record_function
    outstanding: collections.deque = collections.deque()
    run.batch_calls = [0] * len(pool)
    calls = 0
    submit = 0.0
    with record(tracing.WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if time.perf_counter() >= deadline:
                break
            b = calls % len(pool)
            with record(tracing.SUBMIT):
                s0 = time.perf_counter()
                out = call(system, pool[b])
                mark = _mark(device)
                submit += time.perf_counter() - s0
            outstanding.append((calls, b, out, mark))
            run.batch_calls[b] += 1
            calls += 1
            while len(outstanding) >= in_flight:
                with record(tracing.WAIT):
                    done = outstanding.popleft()
                    done[3].synchronize()
                with record(tracing.POOL):
                    sampler.offer(*done[:3])
        with record(tracing.WAIT):
            while outstanding:
                done = outstanding.popleft()
                done[3].synchronize()
                sampler.offer(*done[:3])
        run.window_s = time.perf_counter() - t0
    run.calls = calls
    run.submit_s = submit
    run.codes_answered = sum(n * int(pool[b].numel()) for b, n in enumerate(run.batch_calls))


class Sampler:
    """A uniform sample of the window's calls (reservoir sampling, its
    choices drawn from the seed), with their answers."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(f"kmerbench sample {seed}")
        self.size = size
        self.kept: list[tuple[int, int, torch.Tensor]] = []
        self.seen = 0

    def offer(self, call: int, batch: int, out: torch.Tensor) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((call, batch, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = (call, batch, out)


def check(kept, pool, reference) -> dict:
    """The reference's answers for every kept call, compared whole."""
    expected = {}
    mismatches = 0
    checked = 0
    absent = 0
    for _, b, out in sorted(kept, key=lambda t: t[0]):
        if b not in expected:
            expected[b] = reference.answers(pool[b]) & 0xFFFFFFFF
        got = out.reshape(-1)
        if got.dtype == torch.uint32:
            got = got.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        got = got.to(torch.int64)
        if got.shape != expected[b].shape:
            mismatches += int(expected[b].numel())
        else:
            mismatches += int((got != expected[b]).sum())
        checked += int(expected[b].numel())
        absent += int((expected[b] == 0).sum())
    return {"mismatches": mismatches, "answers_checked": checked, "calls_checked": len(kept),
            "answers_absent": absent}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, system: str = "port", log=sys.stderr,
             strict: bool = True) -> dict:
    """Run ``workload`` once and return its result line as a dict.

    ``t_start`` is the host clock at the process's start (set-up counts
    from it). ``system`` names what answers the calls (``SYSTEMS``), or is
    a class of the same interface.
    ``strict`` requires every metric the cell reports to be read; the CPU
    tests, which have no device clock or allocator, run with it off."""
    device = torch.device(device)
    spec = Spec(root)
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    traffic = hooks(spec.mix_code(cell["traffic"]))
    run = Run(cell=cell, config=config, mix=mix, spec=spec)
    stages = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        run.device_kind = torch.cuda.get_device_name(device)
        torch.cuda.init()
    stages["device"] = time.perf_counter() - t_start

    corpus = make_corpus(config, seed, device)
    _sync(device)
    stages["corpus"] = time.perf_counter() - t_start
    pool = traffic.make_pool(mix, corpus, config, seed, device)
    run.pool_stats = [traffic.batch_stats(b, config) for b in pool]
    _sync(device)
    stages["pool"] = time.perf_counter() - t_start
    print(f"kmerbench: {len(corpus.reads)} reads; distinct entries a batch "
          f"{[s.distinct for s in run.pool_stats]} of {run.pool_stats[0].n}", file=log)
    sut = (SYSTEMS[system] if isinstance(system, str) else system)(config, device)
    sut.prepare(corpus)
    _sync(device)
    stages["prepare"] = time.perf_counter() - t_start
    before = _allocated(device)

    t0 = time.perf_counter()
    sut.build()
    first = traffic.call(sut, pool[0])
    _sync(device)
    run.build_s = time.perf_counter() - t0
    stages["build"] = time.perf_counter() - t_start
    del first
    for batch in pool:
        traffic.call(sut, batch)
    _sync(device)
    after = _allocated(device)
    if before is not None:
        run.index_bytes = after - before
    run.setup_s = time.perf_counter() - t_start
    stages["warm"] = run.setup_s
    print(f"kmerbench: {workload} seed {seed}: set-up {run.setup_s:.3f} s "
          f"(build and first query {run.build_s:.3f} s)", file=log)
    print("kmerbench: set-up stages, host seconds since start: "
          + " ".join(f"{name} {t:.3f}" for name, t in stages.items()), file=log)

    sampler = Sampler(seed, SAMPLE_CALLS)
    in_flight = int(mix["in_flight"])
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            _window(sut, traffic.call, pool, in_flight, seconds, device, sampler, run)
        t_trace = time.perf_counter()
        run.trace = tracing.summarize(prof.profiler.kineto_results.events())
        del prof
        print(f"kmerbench: trace of {run.calls} calls reduced in "
              f"{time.perf_counter() - t_trace:.3f} s", file=log)
    else:
        _window(sut, traffic.call, pool, in_flight, seconds, device, sampler, run)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")

    sut.close()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = check(sampler.kept, pool, traffic.reference(corpus.reads, config))
    print(f"kmerbench: reference check {time.perf_counter() - t_check:.3f} s", file=log)

    metrics = {}
    for entry in spec.metrics(workload, trace):
        value = spec.reader(entry["name"]).read(run)
        if value is None:
            if strict:
                if run.trace is not None:
                    print(f"kmerbench: device operations {sorted(run.trace.ops)}", file=log)
                raise RuntimeError(f"metric {entry['name']} has no reading in {workload}")
            continue
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    checks = {name: {"value": checked[name], "limit": limit} for name, limit in LIMITS.items()}
    correct = checked["calls_checked"] > 0 and all(
        checked[name] <= limit for name, limit in LIMITS.items())
    result = {"correct": correct, "attempted": run.calls, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": run.device_kind, "count": 1, "memory_peak_bytes": peak}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    print(f"kmerbench: checked {checked['answers_checked']} answers of "
          f"{checked['calls_checked']} calls of {run.calls}, {checked['answers_absent']} of "
          f"them absent from the reads", file=log)
    return result
