"""Multi-process start-up of the PyTorch port (``parallel/multihost.py``),
mirroring ``tests/test_parallel.py:174`` and ``:186``: the single-process
no-op, the JAX launch variables, ``TOPO4D_MULTIHOST=auto`` and torchrun's
variables (``env://``, raising outside a launcher), a second call as a
no-op, host 0 by rank, and each rank's card (``cuda:<LOCAL_RANK>``, raising
past the cards present). ``torch.distributed.init_process_group`` is
replaced by a recorder where a call would join a real group."""

import pytest
import torch

from topo4d_tpu_torch.parallel import multihost

LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "TOPO4D_MULTIHOST", "WORLD_SIZE",
               "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean(monkeypatch):
    """A process that has not called ``initialize_multihost``, without
    launch variables."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for attr in ("_done", "_distributed", "_device"):
        monkeypatch.setattr(multihost.initialize_multihost, attr, None, raising=False)


@pytest.fixture
def fresh(clean, monkeypatch):
    """``clean``, with ``init_process_group`` replaced by a recorder of its
    arguments (the list returned)."""
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda *a: calls[-1].get("rank", 0))
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda *a: calls[-1].get("world_size", 2))
    return calls


def test_single_process_noop(clean):
    assert multihost.initialize_multihost(device="cpu") is False
    assert multihost.initialize_multihost(device="cpu") is False  # idempotent
    assert multihost.is_host0() is True
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.rank_device("cpu") == torch.device("cpu")


def test_jax_launch_variables(fresh, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert multihost.initialize_multihost(device="cpu") is True
    assert fresh == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}]
    # a second call is a no-op
    assert multihost.initialize_multihost(device="cpu") is True
    assert len(fresh) == 1


def test_one_jax_process_is_single(fresh, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert multihost.initialize_multihost(device="cpu") is False
    assert fresh == []


def test_jax_launch_needs_the_process_id(fresh, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        multihost.initialize_multihost(device="cpu")


def test_torchrun_variables_take_env_init(fresh, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert multihost.initialize_multihost(device="cpu", backend="gloo") is True
    assert fresh == [{"backend": "gloo", "init_method": "env://"}]
    assert multihost.rank_device() == torch.device("cpu")


@pytest.mark.parametrize("env", [{"TOPO4D_MULTIHOST": "auto"}, {"WORLD_SIZE": "2"}])
def test_auto_raises_outside_a_launcher(clean, monkeypatch, env):
    """No ``RANK``/``MASTER_ADDR``: the env:// rendezvous fails, and the
    failure raises instead of leaving every process host 0."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        multihost.initialize_multihost(device="cpu")
    assert not multihost.initialize_multihost._done


def _two_cards(monkeypatch):
    pinned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pinned.append(d))
    return pinned


def test_rank_pinned_to_its_card(fresh, monkeypatch):
    pinned = _two_cards(monkeypatch)
    monkeypatch.setenv("TOPO4D_MULTIHOST", "auto")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.initialize_multihost() is True
    assert fresh == [{"backend": "nccl", "init_method": "env://"}]
    assert pinned == [torch.device("cuda", 1)] and multihost.rank_device() == torch.device("cuda", 1)


def test_card_index_past_the_cards_raises(fresh, monkeypatch):
    _two_cards(monkeypatch)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")  # no LOCAL_RANK: the process id picks the card
    with pytest.raises(RuntimeError, match="cuda:3"):
        multihost.initialize_multihost()
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="cuda:2"):
        multihost.initialize_multihost()
    assert fresh == []


def test_explicit_card_and_backend_taken_as_given(fresh, monkeypatch):
    """Ranks that share one card (chip_smoke.py's phase 10): ``cuda:0`` and
    gloo, whatever the rank."""
    pinned = _two_cards(monkeypatch)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert multihost.initialize_multihost(device="cuda:0", backend="gloo") is True
    assert fresh[0]["backend"] == "gloo" and pinned == [torch.device("cuda", 0)]


def test_host0_is_rank_0(monkeypatch, capsys):
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda *a: 2)
    assert multihost.is_host0() is False and multihost.process_count() == 2
    multihost.host0_print("quiet")
    monkeypatch.setattr(multihost.dist, "get_rank", lambda *a: 0)
    assert multihost.is_host0() is True
    multihost.host0_print("loud")
    assert capsys.readouterr().out == "loud\n"
