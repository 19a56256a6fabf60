"""The port's exit-code taxonomy against the JAX package's, on the CPU.

``exit_code_for_exception`` of both packages over the same exception
chains, each built from the classes both packages have (the topology and
divergence errors from each package's own module); ``train`` with the
trainer's run method raising ``ConnectionError`` exits 75 in both CLIs;
the refusals that cite a ROADMAP.md item (the ``hf_text`` data module and
the ``hf:`` tokenizer); the subcommands once refused (``plan``, ``tune``,
``promote``, ``fleet``) answering a config they cannot run as JAX's do;
``chaos`` rejects fewer than one cycle as JAX does.
"""

from __future__ import annotations

import json

import pytest
from test_torch_train_cli import _CITES_STABLE_ITEM, STABLE_ITEMS, _config
from torch_port_helpers import run_cli

from llmtrain_tpu.cli import main as jax_main
from llmtrain_tpu.resilience import elastic as jax_elastic
from llmtrain_tpu.resilience import exit_codes as jax_codes
from llmtrain_tpu.resilience import guard as jax_guard
from llmtrain_tpu.training.trainer import Trainer as JaxTrainer
from llmtrain_tpu_torch.cli import main as port_main
from llmtrain_tpu_torch.resilience import exit_codes as port_codes
from llmtrain_tpu_torch.training import trainer as port_trainer

# (exit_code_for_exception, TopologyMismatchError, NonFiniteLossError,
# RetryableInfraError) of each package.
_JAX = (jax_codes.exit_code_for_exception, jax_elastic.TopologyMismatchError,
        jax_guard.NonFiniteLossError, jax_codes.RetryableInfraError)
_PORT = (port_codes.exit_code_for_exception, port_trainer.TopologyMismatchError,
         port_trainer.NonFiniteLossError, port_codes.RetryableInfraError)


def _raised(make) -> BaseException:
    try:
        make()
    except BaseException as exc:  # noqa: BLE001 — the chain under test
        return exc
    raise AssertionError("the chain builder raised nothing")


def _from(outer: BaseException, inner: BaseException):
    def make():
        raise outer from inner
    return make


def _while_handling(outer: BaseException, inner: BaseException, *, sever: bool):
    def make():
        try:
            raise inner
        except type(inner):
            if sever:
                raise outer from None
            raise outer  # noqa: B904 — the implicit context is the point
    return make


def _cycle() -> BaseException:
    a, b = RuntimeError("a"), TimeoutError("b")
    a.__context__, b.__context__ = b, a
    return a


_CHAINS = {
    "bare-ConnectionError": lambda topo, nf, retry: ConnectionError("reset"),
    "bare-TimeoutError": lambda topo, nf, retry: TimeoutError("rendezvous"),
    "bare-InterruptedError": lambda topo, nf, retry: InterruptedError("eintr"),
    "bare-RetryableInfraError": lambda topo, nf, retry: retry("flaky"),
    "RuntimeError-from-TimeoutError":
        lambda topo, nf, retry: _raised(_from(RuntimeError("wrapped"), TimeoutError("t"))),
    "implicit-context-of-ConnectionError": lambda topo, nf, retry: _raised(
        _while_handling(KeyError("k"), ConnectionError("c"), sever=False)),
    "raise-from-None-severs": lambda topo, nf, retry: _raised(
        _while_handling(ValueError("v"), ConnectionError("c"), sever=True)),
    "wrapped-TopologyMismatchError":
        lambda topo, nf, retry: _raised(_from(RuntimeError("resume"), topo("mesh"))),
    "TopologyMismatchError-over-TimeoutError":
        lambda topo, nf, retry: _raised(_from(topo("mesh"), TimeoutError("t"))),
    "NonFiniteLossError-wrapping-ConnectionError":
        lambda topo, nf, retry: _raised(_from(nf("diverged"), ConnectionError("c"))),
    "unknown-error": lambda topo, nf, retry: KeyError("bug"),
    "OSError-is-not-transient": lambda topo, nf, retry: FileNotFoundError("missing"),
    "cycle": lambda topo, nf, retry: _cycle(),
}
_EXPECTED = {
    "bare-ConnectionError": 75, "bare-TimeoutError": 75, "bare-InterruptedError": 75,
    "bare-RetryableInfraError": 75, "RuntimeError-from-TimeoutError": 75,
    "implicit-context-of-ConnectionError": 75, "raise-from-None-severs": 1,
    "wrapped-TopologyMismatchError": 2, "TopologyMismatchError-over-TimeoutError": 2,
    "NonFiniteLossError-wrapping-ConnectionError": 1, "unknown-error": 1,
    "OSError-is-not-transient": 1, "cycle": 75,
}


@pytest.mark.parametrize("chain", sorted(_CHAINS))
def test_exit_code_equals_jax_on_the_chain(chain: str) -> None:
    codes = []
    for classify, topo, nf, retry in (_JAX, _PORT):
        codes.append(classify(_CHAINS[chain](topo, nf, retry)))
    assert codes[1] == codes[0] == _EXPECTED[chain], (chain, codes)


def test_refusal_anywhere_in_the_chain_is_a_config_error() -> None:
    """The port's own convention, checked before JAX's walks: a feature
    not yet ported is a config error even under a transient wrapper."""
    exc = _raised(_from(ConnectionError("c"), NotImplementedError("not yet ported")))
    assert port_codes.exit_code_for_exception(exc) == 2
    assert port_codes.is_retryable(75) and port_codes.is_retryable(76)
    assert not port_codes.is_retryable(1) and not port_codes.is_retryable(2)
    for name in ("EXIT_OK", "EXIT_TRAIN_FAILURE", "EXIT_CONFIG_ERROR", "EXIT_RETRYABLE_INFRA",
                 "EXIT_HANG_DETECTED", "RETRYABLE_EXIT_CODES", "FATAL_EXIT_CODES"):
        assert getattr(port_codes, name) == getattr(jax_codes, name), name


@pytest.mark.parametrize("package", ["jax", "port"])
def test_connection_error_escaping_train_exits_75(tmp_path, capsys, monkeypatch, package) -> None:
    """A transient fault in the run itself (the trainer's ``fit``; JAX
    retries data setup with backoff, so that is not where to inject it)
    exits 75, the code the job spec retries, in both CLIs."""
    def fit(self, *args, **kwargs):
        raise ConnectionError("storage blip")

    trainer_cls, main = (JaxTrainer, jax_main) if package == "jax" else \
        (port_trainer.Trainer, port_main)
    monkeypatch.setattr(trainer_cls, "fit", fit)
    cfg = _config(tmp_path)
    assert run_cli(main, ["train", "--config", str(cfg), "--run-id", "blip"]) == 75
    assert "(exit 75)" in capsys.readouterr().err


# Once refused citing their ROADMAP.md item, ported since: ``plan`` and
# ``tune`` (autotune) exit 2 for a plan that cannot run, ``promote`` and
# ``fleet`` (lifecycle and fleet) for a config they cannot run, each with
# JAX's exit code and error.
_PORTED = {"plan": "autotune", "tune": "autotune", "promote": "lifecycle and fleet",
           "fleet": "lifecycle and fleet"}


def _both_cli(argv: list[str], capsys) -> list[tuple[int, str]]:
    """(exit code, JSON error) of JAX's CLI and of the port's on ``argv``."""
    out = []
    for main in (jax_main, port_main):
        code = run_cli(main, argv)
        out.append((code, json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]))
    return out


@pytest.mark.parametrize("command", sorted(_PORTED))
def test_unported_subcommand_exits_2_citing_its_item(tmp_path, capsys, command: str) -> None:
    assert _PORTED[command] in STABLE_ITEMS
    if command in ("plan", "tune"):
        cfg = _config(tmp_path, **{"distributed.mesh.tensor": 3})
        assert run_cli(port_main, [command, "--config", str(cfg), "--json"]) == 2
        err = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["error"]
        assert err.startswith("infeasible plan: ") and "not yet ported" not in err, err
        return
    cfg = _config(tmp_path)
    extra = ["--watch", str(tmp_path / "no-run")] if command == "promote" else []
    (jax_code, jax_err), (code, err) = _both_cli([command, "--config", str(cfg), *extra],
                                                 capsys)
    assert code == jax_code == 2 and err == jax_err, (err, jax_err)
    assert not _CITES_STABLE_ITEM.search(err) and "not yet ported" not in err, err


@pytest.mark.parametrize(
    "command,case",
    [("fleet", "fleetless"), ("fleet", "unloadable"), ("fleet", "one-tenant-storm"),
     ("promote", "missing-watch"), ("promote", "unloadable"), ("promote", "bad-lora")],
)
def test_promote_and_fleet_config_errors_match_jax(tmp_path, capsys, command, case) -> None:
    """``promote`` and ``fleet`` answer a config they cannot run as JAX's
    do: the same exit code (2) and the same error."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    overrides = {}
    if case == "bad-lora":
        overrides["model.extra.lora"] = {"rank": 0}
    if case == "one-tenant-storm":
        overrides["fleet.tenants"] = [{"name": "solo"}]
    cfg = _config(tmp_path, **overrides)
    if case == "unloadable":
        cfg.write_text("run: [this is not a mapping\n")
    argv = [command, "--config", str(cfg)]
    if command == "promote":
        argv += ["--watch", str(run_dir if case != "missing-watch" else tmp_path / "gone")]
    if case == "one-tenant-storm":
        argv += ["--storm"]
    (jax_code, jax_err), (code, err) = _both_cli(argv, capsys)
    assert code == jax_code == 2 and err == jax_err, (err, jax_err)


@pytest.mark.parametrize("extra", [["--cycles", "0"], ["--cycles", "-1"]],
                         ids=["zero", "negative"])
def test_chaos_rejects_fewer_than_one_cycle_as_jax(tmp_path, capsys, extra) -> None:
    """What the ``chaos`` refusal became: both CLIs give exit 2 and the
    same error for ``--cycles`` below 1, before any segment runs."""
    cfg = _config(tmp_path)
    answers = []
    for main in (jax_main, port_main):
        assert run_cli(main, ["chaos", "--config", str(cfg), *extra]) == 2
        answers.append(json.loads(capsys.readouterr().err.strip().splitlines()[-1]))
    assert answers[1] == answers[0] == {"error": "--cycles must be >= 1"}


@pytest.mark.parametrize("command", ["goodput", "profile"])
def test_ported_telemetry_subcommands_answer_as_jax(tmp_path, capsys, command: str) -> None:
    """What the refusals of ``goodput`` and ``profile`` became: both CLIs
    give the same exit code and error for a run dir that does not exist,
    a config that does not load, and ``profile --steps 0``; and argparse's
    own error for an unknown flag."""
    cases = {
        "goodput": [(["--run-dir", str(tmp_path / "absent")], 2),
                    (["--run-dir", str(tmp_path)], 1)],
        "profile": [(["--config", str(tmp_path / "absent.yaml")], 2),
                    (["--config", str(_config(tmp_path)), "--steps", "0"], 2)],
    }[command]
    for extra, expected in cases:
        answers = []
        for main in (jax_main, port_main):
            assert run_cli(main, [command, *extra]) == expected, (command, extra)
            answers.append(json.loads(capsys.readouterr().err.strip().splitlines()[-1]))
        assert answers[1] == answers[0], (command, extra)
    with pytest.raises(SystemExit) as excinfo:
        port_main([command, "--anything", "x"])
    assert excinfo.value.code == 2


def test_a_misspelt_subcommand_is_still_argparse_s_error(capsys) -> None:
    with pytest.raises(SystemExit) as excinfo:
        port_main(["promot"])
    assert excinfo.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    with pytest.raises(SystemExit) as excinfo:
        port_main(["validate", "--config", "x.yaml", "--bogus"])
    assert excinfo.value.code == 2


@pytest.mark.parametrize(
    "override,item",
    [({"data.name": "hf_text"}, "smoke presets and offline data"),
     ({"model.extra.tokenizer": "hf:tokenizer.json"}, "model zoo")],
    ids=["hf_text", "hf-tokenizer"],
)
def test_download_bound_parts_exit_2_citing_an_item(tmp_path, capsys, override, item) -> None:
    cfg = _config(tmp_path, **override)
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "hf"]) == 2
    err = capsys.readouterr().err
    assert _CITES_STABLE_ITEM.search(err) and f"queue A: {item})" in err, err


def test_unknown_data_module_keeps_the_registry_error(tmp_path, capsys) -> None:
    cfg = _config(tmp_path, **{"data.name": "no_such_data"})
    assert run_cli(port_main, ["train", "--config", str(cfg), "--run-id", "x"]) == 2
    err = capsys.readouterr().err
    assert "Unknown data module 'no_such_data'" in err and "ROADMAP" not in err
