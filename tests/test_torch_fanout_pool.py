"""The fan-out's pool on the CPU (multiprime_tpu_torch/pipeline/driver.py):
clusters that run torch ops go to workers forked from a forkserver that
imported torch and the port once; each worker takes the environment and
working directory of the job it serves, and the trees are those of the
run in one process."""

import os

import torch
from torch.profiler import ProfilerActivity, profile

from multiprime_tpu_torch.pipeline import driver
from multiprime_tpu_torch.utils import trace

from .test_torch_pipeline import PIPE_KW, _three_families, _tree

DEVICE_KW = dict(device="cpu", stage_a="device",
                 align_backend="centerstar-device", **PIPE_KW)


class _Probe(driver.Pipeline):
    """A pipeline whose pool's workers report their own state in place
    of running a cluster."""

    def _pooled_cluster(self, name):
        return {"env": dict(os.environ), "cwd": os.getcwd(),
                "pid": os.getpid(),
                "bad_fork": torch.cuda._is_in_bad_fork()}


def _probe(tmp_path):
    """The workers' reports of a two-worker fan-out of a device Stage-A
    pipeline, and the environment it was made under."""
    pipe = _Probe(driver.PipelineConfig(results_dir=str(tmp_path),
                                        device="cpu", stage_a="device"))
    env = dict(os.environ)
    return pipe._fan_out(["a_2", "b_1"], 2), env, pipe


def _server_environ():
    with open("/proc/%d/environ" % driver._SERVER_PID, "rb") as f:
        return dict(item.decode().split("=", 1)
                    for item in f.read().split(b"\0") if b"=" in item)


def test_forkserver_runs_equal_the_run_in_process(tmp_path):
    """Two device Stage-A runs with two workers in one process write the
    tree of the run in one process, byte for byte (all into one path, one
    after the other); both pools fork from the forkserver, and the second
    run's finds it warm: its traced `fanout` span counts it."""
    fa = tmp_path / "three.fa"
    _three_families(fa)
    res = tmp_path / "res"
    driver.run_pipeline(None, input_fa=str(fa), results_dir=str(res),
                        nproc=1, **DEVICE_KW)
    want = _tree(res)
    os.rename(res, tmp_path / "res_1")
    pipe, _ = driver.run_pipeline(None, input_fa=str(fa),
                                  results_dir=str(res), nproc=2, **DEVICE_KW)
    assert pipe._backends()["pool_start"] == "forkserver"
    assert _tree(res) == want
    os.rename(res, tmp_path / "res_2")
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.request("run"):
            pipe, _ = driver.run_pipeline(None, input_fa=str(fa),
                                          results_dir=str(res), nproc=2,
                                          **DEVICE_KW)
    spans = trace.take()
    assert _tree(res) == want
    backends = pipe._backends()
    assert backends["pool_start"] == "forkserver"
    assert backends["pool_server_warm"] == 1
    fanout = next(s for s in spans if s["name"] == "fanout")
    assert fanout["counts"] == {"clusters": 3, "workers": 2,
                                "pool.forkserver": 1, "pool.server_warm": 1}
    assert len([s for s in spans if s["name"] == "worker.start"]) == 2


def test_host_clusters_keep_fork(tmp_path):
    """Clusters that run no torch op fork from this process, and no
    server is asked for: the host path's pool is as it was."""
    pipe = _Probe(driver.PipelineConfig(results_dir=str(tmp_path),
                                        device="cpu", stage_a="host",
                                        align_backend="centerstar"))
    assert not pipe._clusters_use_torch()
    reports = pipe._fan_out(["a_2", "b_1"], 2)
    assert len(reports) == 2
    assert os.getpid() not in {r["pid"] for r in reports}
    assert pipe.pool == {"pool_start": "fork"}
    assert pipe.server_warm is None


def test_worker_follows_the_parent_environment_and_directory(
        tmp_path, monkeypatch):
    """After the server started, the parent sets one variable, removes
    one the server was started with and changes directory: a worker of
    the next pool sees exactly the parent's environment (but for its
    thread count) and its directory."""
    driver._forkserver()
    gone = next(k for k in sorted(_server_environ()) if k in os.environ
                and k != "MPTPU_NATIVE_THREADS")
    monkeypatch.delenv(gone)
    monkeypatch.setenv("MPTPU_FANOUT_TEST", "job-2")
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    reports, env, pipe = _probe(tmp_path)
    assert pipe.pool["pool_start"] == "forkserver"
    env.pop("MPTPU_NATIVE_THREADS", None)
    for rep in reports:
        assert rep["env"].pop("MPTPU_NATIVE_THREADS") == "%d" % max(
            1, (os.cpu_count() or 1) // 2)
        assert rep["env"] == env
        assert rep["env"]["MPTPU_FANOUT_TEST"] == "job-2"
        assert gone not in rep["env"]
        assert rep["cwd"] == str(work)


def test_worker_can_use_cuda_and_server_holds_one_thread(tmp_path):
    """A worker is not in torch's bad fork (its first CUDA call may make
    a context), and the server, torch and the port imported, runs one
    thread."""
    reports, _, pipe = _probe(tmp_path)
    assert pipe.pool["pool_start"] == "forkserver"
    assert not any(rep["bad_fork"] for rep in reports)
    assert all(rep["pid"] != driver._SERVER_PID for rep in reports)
    assert os.listdir("/proc/%d/task" % driver._SERVER_PID) == [
        str(driver._SERVER_PID)]
