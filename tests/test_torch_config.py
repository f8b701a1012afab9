"""The port's knob registry read as the reference registry reads it:
every knob of ``grit_tpu_torch.api.config`` under an unset, an empty, a
malformed and a valid value gives the value ``grit_tpu.api.config``
gives (an empty value counts as unset, a malformed number warns and
reads the default, a flag is on unless it is ``"0"``); and the flight
log's file name is the reference's."""

from __future__ import annotations

import pytest

from grit_tpu.api import config as ref
from grit_tpu.device import agentlet as ref_agentlet
from grit_tpu_torch.api import config as port
from grit_tpu_torch.device import agentlet as port_agentlet

KNOBS = sorted((k for k in vars(port).values() if isinstance(k, port.Knob)),
               key=lambda k: k.name)

# The typed read the port uses for each of the reference's knob types.
READ = {"str": "get", "int": "get_int", "float": "get_float",
        "bool": "get_flag"}
MALFORMED = {"str": "not/a-dir name", "int": "2.5", "float": "abc",
             "bool": "no"}
VALID = {"str": "/srv/grit", "int": "7", "float": "12.5", "bool": "0"}
VALUES = {"unset": lambda t: None, "empty": lambda t: "",
          "malformed": MALFORMED.get, "valid": VALID.get}


def test_every_port_knob_is_a_reference_knob():
    assert len(KNOBS) >= 25
    for knob in KNOBS:
        assert knob.name in ref.REGISTRY, knob.name
        assert ref.REGISTRY[knob.name].type in READ


@pytest.mark.parametrize("case", sorted(VALUES))
@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: k.name)
def test_knob_reads_as_the_reference_registry(knob, case, monkeypatch):
    want_knob = ref.REGISTRY[knob.name]
    raw = VALUES[case](want_knob.type)
    if raw is None:
        monkeypatch.delenv(knob.name, raising=False)
    else:
        monkeypatch.setenv(knob.name, raw)
    got = getattr(knob, READ[want_knob.type])()
    want = want_knob.get()
    assert type(got) is type(want) and got == want, (knob.name, raw)


@pytest.mark.parametrize("name", ["GRIT_SNAP_SPECULATE",
                                  "GRIT_SNAP_SPECULATE_WAIT_S",
                                  "GRIT_RESTORE_POSTCOPY",
                                  "GRIT_RESTORE_POSTCOPY_HOT_MB"])
def test_speculation_and_postcopy_knobs_are_declared(name, monkeypatch):
    """The knobs validated speculation and post-copy read are the port's
    own, with the reference's names and defaults."""
    monkeypatch.delenv(name, raising=False)
    knob = next(k for k in KNOBS if k.name == name)
    want = ref.REGISTRY[name]
    assert getattr(knob, READ[want.type])() == want.get()


@pytest.mark.parametrize("name", ["GRIT_SNAPSHOT_CODEC", "GRIT_CODEC_WORKERS",
                                  "GRIT_CODEC_MIN_RATIO", "GRIT_CODEC_SAMPLE_KB",
                                  "GRIT_WIRE_IFACES"])
def test_codec_and_wire_knobs_are_declared(name, monkeypatch):
    """The knobs the codec stage and the wire read are the port's own, with
    the reference's names and defaults."""
    monkeypatch.delenv(name, raising=False)
    knob = next(k for k in KNOBS if k.name == name)
    want = ref.REGISTRY[name]
    assert getattr(knob, READ[want.type])() == want.get()


@pytest.mark.parametrize("name", ["GRIT_FLIGHT", "GRIT_FLIGHT_DIR",
                                  "GRIT_FLIGHT_CLOCK", "GRIT_TPU_TRACE_FILE",
                                  "GRIT_WORKLOAD_METRICS_PORT",
                                  "GRIT_FAULT_POINTS"])
def test_obs_and_fault_knobs_are_declared(name, monkeypatch):
    """The knobs the flight recorder, the trace sink, the workload's
    ``/metrics`` and the fault registry read are the port's own, with the
    reference's names and defaults."""
    monkeypatch.delenv(name, raising=False)
    knob = next(k for k in KNOBS if k.name == name)
    want = ref.REGISTRY[name]
    assert getattr(knob, READ[want.type])() == want.get()


@pytest.mark.parametrize("name", ["GRIT_PROF_HZ", "GRIT_PROF_MAX_STACKS",
                                  "GRIT_OBS_SAMPLE_S", "GRIT_TPU_GIT_SHA"])
def test_profiler_sampler_and_version_knobs_are_declared(name, monkeypatch):
    """The knobs the phase profiler, the sampler and the ``/version`` stamp
    read are the port's own, with the reference's names and defaults."""
    monkeypatch.delenv(name, raising=False)
    knob = next(k for k in KNOBS if k.name == name)
    want = ref.REGISTRY[name]
    assert getattr(knob, READ[want.type])() == want.get()


def test_flight_log_name_is_the_reference_metadata():
    from grit_tpu import metadata as ref_metadata
    from grit_tpu_torch import metadata

    assert metadata.FLIGHT_LOG_FILE == ref_metadata.FLIGHT_LOG_FILE


def test_empty_socket_dir_is_the_default_for_both_packages(monkeypatch):
    """With ``GRIT_TPU_SOCKET_DIR=""`` the port's agentlet listens where
    the reference's hook looks: ``/tmp``, not the cwd."""
    monkeypatch.setenv("GRIT_TPU_SOCKET_DIR", "")
    assert port_agentlet.socket_path(1) == ref_agentlet.socket_path(1) == \
        "/tmp/grit-tpu-1.sock"
