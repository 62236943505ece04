"""Lightweight run metrics: per-stage walls, device-memory highwater, and
derived throughput numbers.

The reference's only observability is `date +%s` deltas in pipeline.sh and
`/usr/bin/time -v` parsing in the paper harness (SURVEY.md section 5). Here
every pipeline stage records into a process-global registry that bench.py
and the grid runner surface next to accuracy, and `jax.profiler.trace`
captures can be enabled per stage with LHT_PROFILE=<dir>.
"""

from __future__ import annotations

import contextlib
import os
import time

_STAGES: dict[str, float] = {}
_COUNTERS: dict[str, float] = {}
_SERIES: dict[str, list] = {}
_STAGE_RSS: dict[str, float] = {}


def reset() -> None:
    _STAGES.clear()
    _COUNTERS.clear()
    _SERIES.clear()
    _STAGE_RSS.clear()


def add_time(stage: str, seconds: float) -> None:
    _STAGES[stage] = _STAGES.get(stage, 0.0) + seconds


def add(counter: str, value: float) -> None:
    _COUNTERS[counter] = _COUNTERS.get(counter, 0.0) + value


def record(series: str, value: float) -> None:
    """Append one sample to a named series (e.g. per-batch dispatch walls),
    so a single anomalous batch is diagnosable from the bench artifact
    alone."""
    _SERIES.setdefault(series, []).append(float(value))


def series_stats() -> dict:
    """{name: {n, mean, max, p90}} for every recorded series."""
    out = {}
    for name, vals in _SERIES.items():
        if not vals:
            continue
        sv = sorted(vals)
        out[name] = {
            "n": len(vals),
            "mean": round(sum(vals) / len(vals), 3),
            "max": round(sv[-1], 3),
            "p90": round(sv[int(0.9 * (len(sv) - 1))], 3),
        }
    return out


def host_rss_gb() -> float:
    """Current resident set size of this process, GB (from /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 2**20, 3)
    except OSError:
        pass
    return 0.0


def stage_rss() -> dict[str, float]:
    """Host RSS (GB) sampled at the end of each stage."""
    return dict(_STAGE_RSS)


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage; optionally capture a profiler trace for it
    (LHT_PROFILE=<dir> writes one trace per stage to <dir>/<name>)."""
    prof_dir = os.environ.get("LHT_PROFILE")
    ctx = contextlib.nullcontext()
    if prof_dir:
        import jax

        ctx = jax.profiler.trace(os.path.join(prof_dir, name))
    t0 = time.perf_counter()
    with ctx:
        yield
    add_time(name, time.perf_counter() - t0)
    from localhgt_tpu.utils import hostmem

    hostmem.trim()  # return freed arena pages before sampling RSS
    _STAGE_RSS[name] = host_rss_gb()


def stage_walls() -> dict[str, float]:
    return {k: round(v, 3) for k, v in _STAGES.items()}


def counters() -> dict[str, float]:
    return dict(_COUNTERS)


def device_memory_stats() -> dict:
    """Peak/current memory use of device 0; empty on backends that keep no
    memory statistics (the CPU)."""
    import jax

    st = jax.local_devices()[0].memory_stats()
    if st is None:
        return {}
    return {
        "hbm_peak_gb": round(st["peak_bytes_in_use"] / 2**30, 3),
        "hbm_in_use_gb": round(st["bytes_in_use"] / 2**30, 3),
        "peak_bytes_in_use": st["peak_bytes_in_use"],
    }


def derived(n_pairs: int, read_len: int, coder_num: int) -> dict:
    """Throughput numbers, kernel-window and stage-wall kept apart.

    Dividing ideal work by whole STAGE walls (seeding, host IO and
    dispatch latency included) misstates a kernel's rate, so:

    - sw_gcups_kernel: SW cells over the summed synchronous kernel windows
      (`sw_kernel_s` series recorded by ops.sw around each sub-batch —
      H2D + DP + D2H, nothing else).
    - sw_gcups_stage: the old stage-wall proxy, renamed so nobody triages
      kernel perf from it.
    - count_step_gbps_device: count-stage bytes (~9 per k-mer per coder:
      sorted-stream reads + table writes) over the measured device step
      time (`count_step_device_s` series — a synced re-run of one
      representative batch at stage end, recorded by pipeline.extract).
    - count_scatter_gbps_stage: the old stage-wall proxy, renamed.
    """
    out = {}
    w = stage_walls()
    kmers = n_pairs * 2 * max(read_len - 20, 1) * coder_num
    if w.get("count"):
        out["count_scatter_gbps_stage"] = round(kmers * 9 / w["count"] / 1e9, 2)
    step = _SERIES.get("count_step_device_s")
    nb = _COUNTERS.get("count_batches")
    if step and nb:
        bytes_per_batch = kmers * 9 / nb
        out["count_step_gbps_device"] = round(
            bytes_per_batch / (sum(step) / len(step)) / 1e9, 2)
    if w.get("align") and _COUNTERS.get("sw_cells"):
        out["sw_gcups_stage"] = round(
            _COUNTERS["sw_cells"] / w["align"] / 1e9, 2)
    kern = _SERIES.get("sw_kernel_s")
    if kern and _COUNTERS.get("sw_cells"):
        out["sw_gcups_kernel"] = round(
            _COUNTERS["sw_cells"] / sum(kern) / 1e9, 2)
    return out
