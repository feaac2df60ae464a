"""What a traced run records beside the jobs: the card's utilisation as
NVML reports it (``nvidia-smi``, device-wide, so it sees a pool's worker
processes too), and a torch.profiler session in this process, the first
of the process (a later session, or one beside CUDA processes that start
and end, can lose device events).

``"profiler"`` records CPU and CUDA activity (the benchmark's own spans
come in as ``record_function`` ranges); ``"profiler_cuda"`` CUDA activity
alone; ``"nvml"`` samples utilisation and memory every 100 ms.
"""

import json
import os
import subprocess
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, kinds, workdir, device):
        self.kinds = tuple(kinds)
        self.workdir = workdir
        self.device = device
        self.nvml = []               # (t, utilization %, memory MiB)
        self.profile = None
        self._smi = self._smi_out = self._prof = self._window = None
        self._t0 = self._t1 = None

    # -- recording ---------------------------------------------------------
    def start(self):
        import torch
        cuda = torch.device(self.device).type == "cuda"
        if "nvml" in self.kinds and cuda:
            path = os.path.join(self.workdir, "nvml.csv")
            self._smi_out = open(path, "w")
            try:
                self._smi = subprocess.Popen(
                    ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu,"
                     "memory.used", "--format=csv,noheader,nounits",
                     "-lms", "100", "-i", _card_uuid(self.device)],
                    stdout=self._smi_out,
                    stderr=subprocess.DEVNULL)
            except OSError:
                self._smi = None
        kinds = [k for k in self.kinds if k.startswith("profiler")]
        if kinds:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CUDA] if cuda else []
            if kinds[0] == "profiler" or not acts:
                acts.append(ProfilerActivity.CPU)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            from torch.profiler import record_function
            self._window = record_function("perfbench:window")
            self._window.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        self._t1 = time.perf_counter()
        if self._prof is not None:
            self._window.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.workdir, "trace.json")
            self._prof.export_chrome_trace(path)
            self.profile = _read_trace(path)
            os.remove(path)
            self._prof = None
        if self._smi is not None:
            self._smi.terminate()
            try:
                self._smi.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._smi.kill()
                self._smi.wait()
        if self._smi_out is not None:
            self._smi_out.close()
            self.nvml = _read_nvml(self._smi_out.name)

    # -- reading -----------------------------------------------------------
    def window_s(self):
        return self._t1 - self._t0

    def busy_s(self):
        """Seconds in which the card ran an operation: from NVML's
        utilisation where the job kind lists "nvml" and NVML gave samples,
        else the union of the trace's device activity."""
        if "nvml" in self.kinds and self.nvml:
            util = [u for _, u, _ in self.nvml]
            return sum(util) / len(util) / 100.0 * self.window_s()
        if self.profile is not None:
            return self.profile["busy_us"] / 1e6
        return None

    def device_times(self):
        out = {"window_s": self.window_s()}
        busy = self.busy_s()
        if busy is not None:
            out["busy_s"] = busy
        return out

    def breakdown(self, verdict):
        """device_ops: the trace's device operations by total time;
        idle_gaps: the longest gaps in device activity, each named by the
        innermost benchmark span around it, or the job's own account of
        what the host did."""
        ops, gaps = [], []
        if self.profile is not None:
            ops = sorted(self.profile["by_name"].items(),
                         key=lambda kv: -kv[1])[:10]
            ops = [[name, us / 1e6] for name, us in ops]
            gaps = [[name, us / 1e6] for name, us in self.profile["gaps"]]
        gaps = verdict.get("idle_gaps", gaps)
        return {"device_ops": ops, "idle_gaps": gaps[:10]}


def _card_uuid(device):
    """The UUID by which nvidia-smi names the card this process uses:
    nvidia-smi ignores CUDA_VISIBLE_DEVICES, torch's index follows it."""
    import torch
    uuid = str(torch.cuda.get_device_properties(torch.device(device)).uuid)
    return uuid if uuid.startswith("GPU-") else "GPU-" + uuid


def _read_nvml(path):
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append((parts[0], float(parts[1]), float(parts[2])))
            except (IndexError, ValueError):
                continue
    return rows


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _read_trace(path):
    """A chrome trace -> busy microseconds (the union of device activity),
    device time by operation name, the benchmark's spans and the longest
    idle gaps inside the traced window named by the span around them."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, spans = [], []
    by_name = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"),
                                                      0.0) + dur
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(
                "perfbench:"):
            spans.append((ts, ts + dur, e["name"][len("perfbench:"):]))
    merged = _union(device)
    busy = sum(b - a for a, b in merged)
    gaps = []
    window = [s for s in spans if s[2] == "window"]
    if window and merged:
        lo, hi = window[0][0], window[0][1]
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for k in range(0, len(edges) - 1, 2):
            a, b = max(edges[k], lo), min(edges[k + 1], hi)
            if b > a:
                mid = (a + b) / 2
                around = [s for s in spans if s[0] <= mid <= s[1]
                          and s[2] != "window"]
                name = (min(around, key=lambda s: s[1] - s[0])[2]
                        if around else "between jobs")
                gaps.append((name, b - a))
        gaps.sort(key=lambda g: -g[1])
    return {"busy_us": busy, "by_name": by_name, "gaps": gaps[:10]}
