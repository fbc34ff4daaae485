"""Run one cell of the benchmark of `vulkan_radix_sort_tpu_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (its `file`: the sorter
and the call of the program's public entry point) and a traffic mix
(`traffic/<mix>.json`: sizes, key distribution, inputs in rotation). The
run makes the inputs from the seed, creates the sorter, warms up every
input in rotation, then sorts them in turn for `--seconds` as one caller
that waits for each result (a closed loop). Each metric that the cell
reports is read by `metrics/<metric>.py` from the run's records.

With `--trace 0` the window is untouched and the cell's end-to-end metrics
are reported. With `--trace 1` the window is split in four: host spans
only (`enqueue_s`), a short `torch.profiler` slice of device activity only
(`device_busy`: the busy and idle device time), a short one of host and
device activity (`profile`: the breakdown by operation and by what the
host did while the device idled), and CUDA events with the program's
`LaunchTimer` around every sort (`sorts`); the cell's per-layer metrics
are reported.

Once the window has closed, the outputs of the last sort of every input in
rotation are compared with the plain reference (`reference.py`) on the
benchmark's own host copy of the inputs. The last line of standard output
is one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object. Without a
card, or with fewer cards than the cell asks for, the run exits with 2 and
prints no result. A run is one process on one card: a cell that asks for
more cards is refused, since a sort across cards needs a launcher of one
process per card that this harness does not have yet.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()  # set-up counts from here

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import datagen, reference  # noqa: E402

# Top-level module names that may not be loaded in a run: JAX, and the JAX
# package that the port was made from. Compared whole, so that the port,
# whose name begins with the JAX package's, is not taken for it.
FORBIDDEN = ("jax", "jaxlib", "flax", "vulkan_radix_sort_tpu")
PROGRAM = "vulkan_radix_sort_tpu_torch"
# Shares of a traced window: host spans, a profiler slice of device
# activity only, one of host and device activity, then CUDA events and
# launch records.
TRACE_PHASES = (0.4, 0.1, 0.1, 0.4)
WARMUP_ROTATIONS = 2


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of `BENCHMARK.json`: its entry, its configuration,
    its traffic and the metrics it reports."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": _load(root / config["file"]),
        "traffic": _load(HERE / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def resolve(ref: str):
    """`module:function` as the function."""
    module, _, fn = ref.partition(":")
    return getattr(importlib.import_module(module), fn)


def make_inputs(config: dict, traffic: dict, seed: int) -> list[tuple]:
    """The host inputs of every slot in rotation, from the seed: (keys,)
    or (keys, values). Slot s sorts `sizes[s % len(sizes)]` keys of the
    configuration's `key_dtype`, drawn from the seed sequence [seed, s, 0]
    (values: [seed, s, 1]); a traffic's `bits` keeps the low bits only."""
    sizes = traffic["sizes"]
    seed %= 1 << 63
    dtype = np.dtype(config["key_dtype"])

    def one(slot: int) -> tuple:
        n = sizes[slot % len(sizes)]
        keys = datagen.generate_keys(
            n, [seed, slot, 0], traffic["distribution"],
            traffic.get("bits"), dtype)
        if config["values"] is None:
            return (keys,)
        if config["values"] != "uniform":
            raise ValueError(f"unknown values {config['values']!r}")
        return keys, datagen.generate_values(n, [seed, slot, 1])
    with ThreadPoolExecutor(min(4, traffic["rotation"])) as ex:
        return list(ex.map(one, range(traffic["rotation"])))


# Unsigned words by size: numpy's signed and unsigned dtypes, torch's.
# They cross between the two through the signed views, since torch has
# few kernels for unsigned words.
_WORDS = {4: (np.int32, np.uint32, torch.int32, torch.uint32),
          8: (np.int64, np.uint64, torch.int64, torch.uint64)}


def to_device(a: np.ndarray, device) -> torch.Tensor:
    np_i, _, _, t_u = _WORDS[a.dtype.itemsize]
    return torch.from_numpy(a.view(np_i)).to(device).view(t_u)


def to_host(t: torch.Tensor) -> np.ndarray:
    _, np_u, t_i, _ = _WORDS[t.element_size()]
    return t.view(t_i).cpu().numpy().view(np_u)


class Inputs:
    """One slot's tensors on the device and the arguments of its call."""

    def __init__(self, host: tuple, config: dict, device):
        self.n = int(host[0].size)
        self.args = tuple(to_device(a, device) for a in host)
        self.kwargs = dict(config["call_kwargs"])
        if config["count_in_device_memory"]:
            self.kwargs["count"] = torch.tensor(self.n, dtype=torch.int64,
                                                device=device)


def make_program(config: dict, device):
    """The system under test: one Sorter of the configuration, made once,
    and its entry point."""
    import vulkan_radix_sort_tpu_torch as vrs
    sorter = vrs.Sorter(config["max_n"],
                        key_dtype=getattr(torch, config["key_dtype"]),
                        config=vrs.SortConfig(), device=device)
    return getattr(sorter, config["entry"])


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _sync_fn(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _window(call, slots, held, seconds: float, sync) -> dict:
    """The measured window: every slot in turn, each sort awaited, until
    `seconds` have passed and every slot has been sorted once."""
    sort_s, items = [], []
    gc.collect()
    gc.disable()
    try:
        start = now = time.perf_counter()
        i = 0
        while now - start < seconds or i < len(slots):
            slot = slots[i % len(slots)]
            t0 = time.perf_counter()
            out = call(*slot.args, **slot.kwargs)
            sync()
            now = time.perf_counter()
            held[i % len(slots)] = out
            sort_s.append(now - t0)
            items.append(slot.n)
            i += 1
    finally:
        gc.enable()
    return {"window_s": now - start, "sort_s": sort_s, "items": items}


def _turns(slots, seconds: float):
    """Slot indices in rotation until `seconds` have passed and every slot
    has had a turn."""
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds or i < len(slots):
        yield i % len(slots)
        i += 1


def _enqueue_spans(call, slots, held, seconds: float, sync) -> list[float]:
    """Host seconds of each call, up to its return, before its
    synchronize."""
    spans = []
    for s in _turns(slots, seconds):
        t0 = time.perf_counter()
        out = call(*slots[s].args, **slots[s].kwargs)
        spans.append(time.perf_counter() - t0)
        sync()
        held[s] = out
    return spans


def _launch_records(call, slots, held, seconds: float, device) -> list:
    """Every sort between two CUDA events, with the program's LaunchTimer:
    per sort its n, its device seconds, and each launch's name, size and
    start and end in seconds from the sort's first event."""
    from vulkan_radix_sort_tpu_torch.utils.timing import LaunchTimer
    sorts = []
    for s in _turns(slots, seconds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with LaunchTimer() as timer:
            e0.record()
            out = call(*slots[s].args, **slots[s].kwargs)
            e1.record()
        torch.cuda.synchronize(device)
        held[s] = out
        launches = []
        for rec in timer.records:
            launch = {"name": rec["names"][0],
                      "start_s": e0.elapsed_time(rec["events"][0]) / 1e3,
                      "end_s": e0.elapsed_time(rec["events"][1]) / 1e3,
                      "numel": rec.get("numel"), "shift": rec.get("shift"),
                      "nblocks": rec.get("nblocks"),
                      "radix": rec.get("radix")}
            if "config" in rec:  # K7 and K8: geometry from their config
                launch.update(nblocks=rec["numel"] // rec["config"].block,
                              radix=rec["config"].radix)
            launches.append(launch)
        sorts.append({"n": slots[s].n, "call_s": e0.elapsed_time(e1) / 1e3,
                      "launches": launches})
    return sorts


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _host_activity(cpu: list, starts: list, t: float) -> str:
    """Name of the innermost host event of `cpu` (sorted (start, end,
    name); `starts` their starts) running at time t: of those that began
    by t, the last to begin that has not ended."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        a, b, name = cpu[j]
        if b >= t:
            return name
        j -= 1
    return "python, outside any recorded op"


def _device_busy(call, slots, held, seconds: float, sync) -> dict:
    """A torch.profiler slice of the window that records device activity
    only, so that no host event is recorded to slow the host: the device's
    busy seconds (the union of every kernel and copy) and the slice's span
    on the device, from its first operation's start to its last one's
    end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sorts = 0
        for s in _turns(slots, seconds):
            out = call(*slots[s].args, **slots[s].kwargs)
            sync()
            held[s] = out
            sorts += 1
    busy = _union([(e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)])
    window = busy[-1][1] - busy[0][0] if busy else 0.0
    return {"window_s": window / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6, "sorts": sorts}


def _profile(call, slots, held, seconds: float, sync) -> dict:
    """A torch.profiler slice of the window with host and device activity:
    device time by operation name, and idle device time by what the host
    was doing (the recording of host events slows the host, so the idle
    share is read from `_device_busy`'s slice instead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.slice"):
            sorts = 0
            for s in _turns(slots, seconds):
                with record_function("bench.call"):
                    out = call(*slots[s].args, **slots[s].kwargs)
                with record_function("bench.sync"):
                    sync()
                held[s] = out
                sorts += 1
    events = prof.events()
    window = next(e for e in events if e.name == "bench.slice"
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    device, cpu = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("bench."):
                continue
            if b > w0 and a < w1:
                device.append((max(a, w0), min(b, w1), e.name))
        elif e.thread == window.thread and e.name != "bench.slice":
            cpu.append((a, b, e.name))
    cpu.sort()
    starts = [a for a, _, _ in cpu]
    busy = _union([(a, b) for a, b, _ in device])
    by_op: dict[str, float] = {}
    for a, b, name in device:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    by_host: dict[str, float] = {}
    for a, b in gaps:
        name = _host_activity(cpu, starts, a)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:10]
    return {"sorts": sorts, "device_ops": top(by_op),
            "idle_gaps": top(by_host)}


def nvidia_smi() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi failed: {err}"


def check(spec: dict, host_inputs: list, outputs: list) -> tuple[dict, int]:
    """Compare each slot's output with the plain reference. Returns the
    numbers compared, each with its limit (positions mismatched in each
    output array, summed over the slots; limit 0: the comparison is
    exact), and the number of slots whose output was wrong."""
    ref = resolve(spec["config"]["reference"])
    names = ("keys_mismatched", "values_mismatched")
    totals, failed = None, 0
    for inputs, got in zip(host_inputs, outputs):
        want = ref(*inputs)
        counts = [reference.mismatched(g, w) for g, w in zip(got, want)]
        if len(got) != len(want):
            counts = [max(w.size for w in want)] * len(want)
        failed += any(counts)
        totals = counts if totals is None else [
            t + c for t, c in zip(totals, counts)]
    return ({name: {"value": v, "limit": 0}
             for name, v in zip(names, totals)}, failed)


def read_metrics(specs: list, run: dict) -> dict:
    """Each metric's reader, `metrics/<name>.py`; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in specs:
        value = importlib.import_module(
            f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             program=None) -> dict:
    """One run of a cell on `device`; returns the result line. `program`
    (default: the configuration's Sorter entry point) takes the place of
    the system under test. Set-up counts from this module's import."""
    t0 = _T0
    device = torch.device(device)
    sync = _sync_fn(device)
    config, traffic = spec["config"], spec["traffic"]
    marks = [("imports", time.monotonic())]
    host_inputs = make_inputs(config, traffic, seed)
    marks.append(("inputs", time.monotonic()))
    slots = [Inputs(h, config, device) for h in host_inputs]
    call = program or make_program(config, device)
    sync()
    marks.append(("to_device", time.monotonic()))
    held = [None] * len(slots)
    for _ in range(WARMUP_ROTATIONS):
        for s, slot in enumerate(slots):
            held[s] = call(*slot.args, **slot.kwargs)
        sync()
    marks.append(("warmup", time.monotonic()))
    cuda = device.type == "cuda"
    if trace and cuda:
        from vulkan_radix_sort_tpu_torch.utils.timing import LaunchTimer
        with LaunchTimer():  # its events, once
            held[0] = call(*slots[0].args, **slots[0].kwargs)
        _device_busy(call, slots[:1], held, 0.0, sync)  # the profilers,
        _profile(call, slots[:1], held, 0.0, sync)  # once each
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    item_bytes = np.dtype(config["key_dtype"]).itemsize + (
        4 if config["values"] else 0)
    run = {"config": config, "traffic": traffic, "item_bytes": item_bytes,
           "setup_s": time.monotonic() - t0}
    log("[setup] " + " ".join(f"{name}={b - a:.3f}s" for (name, b), a in zip(
        marks, [t0] + [m for _, m in marks])) + f" total={run['setup_s']:.3f}s")
    if not trace:
        run.update(_window(call, slots, held, seconds, sync))
        metrics_spec = spec["end_to_end"]
    else:
        a, b, c, d = (seconds * f for f in TRACE_PHASES)
        run["enqueue_s"] = _enqueue_spans(call, slots, held, a, sync)
        if cuda:
            run["device_busy"] = _device_busy(call, slots, held, b, sync)
            run["profile"] = _profile(call, slots, held, c, sync)
            run["sorts"] = _launch_records(call, slots, held, d, device)
        metrics_spec = spec["per_layer"]
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, window_peak)
        if not trace:
            run["window_mem_bytes"] = window_peak - base
    outputs = [tuple(to_host(t) for t in _as_tuple(out)) for out in held]
    attempted = len(run.get("sort_s", ())) or (
        len(run["enqueue_s"]) + run.get("device_busy", {}).get("sorts", 0)
        + run.get("profile", {}).get("sorts", 0) + len(run.get("sorts", ())))
    del held, slots, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = read_metrics(metrics_spec, run)
    compared, failed = check(spec, host_inputs, outputs)
    result = {
        "correct": all(v["value"] <= v["limit"] for v in compared.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace and "profile" in run:
        busy, prof = run["device_busy"], run["profile"]
        result["device"].update(busy_s=busy["busy_s"],
                                window_s=busy["window_s"])
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["check"] = compared
    return result


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)
    try:
        importlib.import_module(PROGRAM)
    except ImportError as err:
        log(f"the program {PROGRAM} does not import ({err}): no result")
        return 1
    chips = spec["cell"]["chips"]
    if chips != 1:
        log(f"the cell {args.workload} asks for {chips} cards; this harness "
            f"runs one process on one card: no result")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell {args.workload} needs {chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    card = nvidia_smi()
    log(f"[bench] {args.workload} seed={args.seed} seconds={args.seconds} "
        f"trace={args.trace} card: {card}; peak HBM 3.35 TB/s (H100 SXM "
        f"data sheet, at 700 W)")
    result["device"]["power_limit"] = card
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may not load JAX or "
            f"the JAX package; no result")
        return 3
    for name, v in result["check"].items():
        log(f"[check] {name} = {v['value']}  limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
