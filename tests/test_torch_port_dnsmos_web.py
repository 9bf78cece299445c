"""eval/dnsmos_web.py on the CPU, with a stand-in ``requests`` module put into
``sys.modules``: no network is used and ``requests`` need not be installed.

Each call's URI (P.835 or P.808), its JSON payload (the wav's bytes in
base64 and its file name), its headers (the key in ``Authorization``) and
the key taken from ``$DNSMOS_KEY`` are held to what the JAX package's
eval/dnsmos_web.py sends for the same files.
"""

import base64
import os
import sys
import types

import numpy as np
import pytest

from dl_speech_enhancement_tpu.eval import dnsmos_web as jax_web
from dl_speech_enhancement_tpu_torch.data import audio_io
from dl_speech_enhancement_tpu_torch.eval import dnsmos_web
from torch_port_threads import one_thread  # noqa: F401


@pytest.fixture
def requests_stub(monkeypatch):
    """A ``requests`` module whose ``post`` records its arguments and answers
    with a score named after the file."""
    calls = []

    class Response:
        def __init__(self, payload):
            self.payload = payload

        def raise_for_status(self):
            pass

        def json(self):
            return {"mos": float(len(self.payload["filename"]))}

    def post(uri, json=None, headers=None, timeout=None):
        calls.append({"uri": uri, "json": json, "headers": headers, "timeout": timeout})
        return Response(json)

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(post=post))
    return calls


@pytest.fixture
def wavs(tmp_path, rng):
    paths = []
    for sub, name in (("a", "x.wav"), ("b", "longer_name.wav")):
        os.makedirs(tmp_path / sub, exist_ok=True)
        path = str(tmp_path / sub / name)
        audio_io.write_wav(path, (0.3 * rng.standard_normal(480)).astype(np.float32), 16000)
        paths.append(path)
    return paths


@pytest.mark.parametrize("p835,uri", [(True, dnsmos_web.SCORING_URI_DNSMOS_P835),
                                      (False, dnsmos_web.SCORING_URI_DNSMOS)])
def test_score_file_posts_what_the_jax_scorer_posts(requests_stub, wavs, p835, uri):
    got = dnsmos_web.score_file(wavs[0], key="k123", p835=p835)
    jax_web.score_file(wavs[0], key="k123", p835=p835)
    ours, theirs = requests_stub
    assert ours == theirs
    assert ours["uri"] == uri
    assert uri.endswith("/v1/dnsmosp835/score" if p835 else "azurewebsites.net/score")
    with open(wavs[0], "rb") as f:
        assert base64.b64decode(ours["json"]["data"]) == f.read()
    assert ours["json"]["filename"] == "x.wav"
    assert ours["headers"] == {"Content-Type": "application/json",
                               "Authorization": "Basic k123"}
    assert got == {"mos": 5.0}


def test_the_key_comes_from_the_environment(requests_stub, wavs, monkeypatch):
    monkeypatch.setenv("DNSMOS_KEY", "from-env")
    dnsmos_web.score_file(wavs[0])
    assert requests_stub[0]["headers"]["Authorization"] == "Basic from-env"
    dnsmos_web.score_file(wavs[0], key="given")
    assert requests_stub[1]["headers"]["Authorization"] == "Basic given"


def test_a_missing_key_raises(requests_stub, wavs, monkeypatch):
    monkeypatch.delenv("DNSMOS_KEY", raising=False)
    with pytest.raises(RuntimeError, match="DNSMOS_KEY"):
        dnsmos_web.score_file(wavs[0])
    assert requests_stub == []


def test_score_dir_scores_every_wav_in_order(requests_stub, wavs, tmp_path):
    rows = dnsmos_web.score_dir(str(tmp_path), key="k")
    assert [r["filename"] for r in rows] == sorted(wavs)
    assert rows == jax_web.score_dir(str(tmp_path), key="k")
    assert [r["mos"] for r in rows] == [5.0, 15.0]
