"""The PyTorch port's GPU manifests (k8s/gpu/), without docker or kubectl.

Every manifest parses; every workload runs ``python -m llmtrain_tpu_torch``
(the train Job through k8s/gpu/entrypoint.sh) and asks for
``nvidia.com/gpu``; the ConfigMap's run configs validate with the port's
loader and name the card; the fleet pod holds a card for each rank of its
widest tenant. k8s/gpu/entrypoint.sh runs k8s/entrypoint.sh's rank
derivation: on ``tests/test_entrypoint.py``'s cases it exports the same
``JAX_*`` environment and exit status as k8s/entrypoint.sh (with a stubbed
``python``/``python3`` that prints them, a stubbed ``curl`` and a temporary
serviceaccount dir), runs the port where that script runs the JAX package,
and the port's ``resolve_topology`` reads the rank, world and rendezvous
from it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch_port_helpers  # noqa: F401
import yaml

from llmtrain_tpu_torch.config import load_and_validate_config
from llmtrain_tpu_torch.config.schemas import DistributedConfig
from llmtrain_tpu_torch.distributed import resolve_topology

K8S = Path(__file__).resolve().parents[1] / "k8s"
GPU = K8S / "gpu"
MANIFESTS = sorted(p.name for p in GPU.glob("*.yaml"))


def _docs(name: str) -> list[dict]:
    return [d for d in yaml.safe_load_all((GPU / name).read_text()) if d]


def _pods(doc: dict) -> list[dict]:
    if doc["kind"] in ("Job", "Deployment"):
        return [doc["spec"]["template"]["spec"]]
    return []


def test_every_manifest_is_here() -> None:
    assert MANIFESTS == ["configmap.yaml", "fleet.yaml", "job.yaml", "promote.yaml",
                         "router.yaml", "serve.yaml"]
    dockerfile = (GPU / "Dockerfile").read_text()
    assert "FROM nvidia/cuda:" in dockerfile and "devel" in dockerfile  # nvcc builds the kernels
    assert "COPY llmtrain_tpu_torch/" in dockerfile and "COPY llmtrain_tpu/" not in dockerfile


@pytest.mark.parametrize("name", [m for m in MANIFESTS if m != "configmap.yaml"])
def test_workloads_run_the_port_on_a_card(name: str) -> None:
    pods = [p for d in _docs(name) for p in _pods(d)]
    assert pods, name
    for pod in pods:
        for c in pod["containers"]:
            cmd = c["command"]
            if cmd[:2] == ["/bin/bash", "/app/k8s/gpu/entrypoint.sh"]:
                assert name == "job.yaml"
            else:
                assert cmd[:3] == ["python", "-m", "llmtrain_tpu_torch"], (name, cmd)
                assert cmd[3] in ("serve", "fleet", "promote"), cmd
            assert int(c["resources"]["limits"]["nvidia.com/gpu"]) >= 1, name
            assert c["image"].startswith("llmtrain-torch-gpu")
            assert "JAX_PLATFORMS" not in {e["name"] for e in c.get("env", [])}
        volumes = {v["name"]: v for v in pod["volumes"]}
        assert volumes["config"]["configMap"]["name"] == "llmtrain-torch-gpu-config"


def _configs() -> dict[str, dict]:
    (cm,) = _docs("configmap.yaml")
    return {k: yaml.safe_load(v) for k, v in cm["data"].items()}


@pytest.mark.parametrize("key", ["train.yaml", "serve.yaml", "promote.yaml", "fleet.yaml"])
def test_configmap_configs_validate_on_the_card(tmp_path, key: str) -> None:
    raw = _configs()[key]
    path = tmp_path / key
    path.write_text(yaml.safe_dump(raw))
    cfg, _, _ = load_and_validate_config(path)
    assert cfg.run.device == "cuda"
    assert cfg.model.attention == "flash" and cfg.model.d_model == 768
    if key == "train.yaml":
        assert cfg.distributed.enabled
    if key == "fleet.yaml":
        (job,) = _docs("fleet.yaml")
        (container,) = job["spec"]["template"]["spec"]["containers"]
        cards = int(container["resources"]["limits"]["nvidia.com/gpu"])
        assert cards >= max(t.max_devices for t in cfg.fleet.tenants)
        assert container["command"][container["command"].index("--config") + 1] == \
            "/config/fleet.yaml"


def test_promote_watches_the_train_jobs_run() -> None:
    (job,) = _docs("job.yaml")
    (promote,) = _docs("promote.yaml")
    env = {e["name"]: e.get("value") for e in
           job["spec"]["template"]["spec"]["containers"][0]["env"]}
    penv = {e["name"]: e.get("value") for e in
            promote["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["LLMTRAIN_RUN_ID"] == penv["LLMTRAIN_RUN_ID"]
    assert env["NUM_PROCESSES"] == str(job["spec"]["completions"])
    assert _configs()["train.yaml"]["output"]["root_dir"] == "/app/runs"


# ------------------------------------------------------------ the entrypoint

FAKE_PYTHON = f"""#!/usr/bin/env bash
if [ "${{1:-}}" = "-c" ]; then exec {sys.executable} "$@"; fi
echo "ARGS=$*"
echo "JAX_PROCESS_ID=${{JAX_PROCESS_ID:-}}"
echo "JAX_NUM_PROCESSES=${{JAX_NUM_PROCESSES:-}}"
echo "JAX_COORDINATOR_ADDRESS=${{JAX_COORDINATOR_ADDRESS:-}}"
"""

FAKE_CURL = """#!/usr/bin/env bash
cat "$FAKE_PODS_JSON"
"""


def _run(script: Path, tmp_path: Path, env: dict[str, str]) -> subprocess.CompletedProcess:
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name, text in (("python", FAKE_PYTHON), ("python3", FAKE_PYTHON), ("curl", FAKE_CURL)):
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)
    full = {"PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}", "HOME": str(tmp_path), **env}
    return subprocess.run(["bash", str(script)], capture_output=True, text=True, env=full,
                          timeout=120)


def _parse(stdout: str) -> dict[str, str]:
    return dict(line.split("=", 1) for line in stdout.splitlines() if "=" in line)


def _case(tmp_path: Path, case: str) -> dict[str, str]:
    rank0 = {"JOB_COMPLETION_INDEX": "0", "NUM_PROCESSES": "4", "POD_IP": "10.0.0.5"}
    if case == "rank0":
        return {**rank0, "LLMTRAIN_CONFIG": "/config/train.yaml"}
    if case == "port-override":
        return {**rank0, "NUM_PROCESSES": "2", "COORDINATOR_PORT": "19999"}
    if case == "rank0-without-pod-ip":
        return {"JOB_COMPLETION_INDEX": "0", "NUM_PROCESSES": "2"}
    if case == "run-id":
        return {**rank0, "LLMTRAIN_RUN_ID": "stable-run"}
    if case == "no-index":
        return {"NUM_PROCESSES": "2"}
    if case == "no-world":
        return {"JOB_COMPLETION_INDEX": "0"}
    pods = {"worker": {"items": [{"status": {"podIP": "10.0.0.9"}}]},
            "worker-no-coordinator": {"items": []},
            "worker-pending-ip": {"items": [{"status": {}}]}}[case]
    sa = tmp_path / "sa"
    sa.mkdir(exist_ok=True)
    for name, text in (("namespace", "trainer-ns"), ("token", "t"), ("ca.crt", "ca")):
        (sa / name).write_text(text)
    (tmp_path / "pods.json").write_text(json.dumps(pods))
    return {"JOB_COMPLETION_INDEX": "2", "NUM_PROCESSES": "4", "JOB_NAME": "llmtrain-job",
            "LLMTRAIN_SA_DIR": str(sa), "FAKE_PODS_JSON": str(tmp_path / "pods.json"),
            "LLMTRAIN_DISCOVERY_TRIES": "3", "LLMTRAIN_DISCOVERY_SLEEP": "0"}


@pytest.mark.parametrize("case", ["rank0", "port-override", "rank0-without-pod-ip", "run-id",
                                  "worker", "worker-no-coordinator", "worker-pending-ip",
                                  "no-index", "no-world"])
def test_entrypoint_derives_ranks_as_k8s_entrypoint(tmp_path, monkeypatch, case: str) -> None:
    if shutil.which("bash") is None:
        pytest.skip("requires bash")
    env = _case(tmp_path, case)
    for side in ("gpu", "jax"):
        (tmp_path / side).mkdir()
    gpu = _run(GPU / "entrypoint.sh", tmp_path / "gpu", env)
    jax = _run(K8S / "entrypoint.sh", tmp_path / "jax", env)
    assert gpu.returncode == jax.returncode, (gpu.stderr, jax.stderr)
    ours, theirs = _parse(gpu.stdout), _parse(jax.stdout)
    if jax.returncode != 0:
        assert ours == theirs == {}
        assert gpu.stderr.splitlines()[-1] == jax.stderr.splitlines()[-1]
        return
    assert theirs["ARGS"].startswith("-m llmtrain_tpu train --config ")
    assert ours.pop("ARGS") == theirs.pop("ARGS").replace("llmtrain_tpu", "llmtrain_tpu_torch", 1)
    assert ours == theirs
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in ours.items():
        monkeypatch.setenv(key, value)
    rank, world, coordinator = resolve_topology(DistributedConfig())
    assert (str(rank), str(world), coordinator) == (
        ours["JAX_PROCESS_ID"], ours["JAX_NUM_PROCESSES"], ours["JAX_COORDINATOR_ADDRESS"])
    if case == "run-id":
        assert "--run-id stable-run --auto-resume" in gpu.stdout
