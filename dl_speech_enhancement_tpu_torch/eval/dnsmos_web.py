"""DNSMOS scoring against the DNSMOS web service (reference DNSMOS/dnsmos.py),
the counterpart of dl_speech_enhancement_tpu/eval/dnsmos_web.py.

Posts each wav, base64-encoded, to the service's endpoint with a
subscription key. It needs network access and the ``requests`` package,
imported at the call; the local scorer (eval/dnsmos.py, cli/dnsmos.py) is the
path that needs neither.
"""

from __future__ import annotations

import base64
import glob
import os

# The public endpoints of the reference script (DNSMOS/dnsmos.py).
SCORING_URI_DNSMOS = "https://dnsmos.azurewebsites.net/score"
SCORING_URI_DNSMOS_P835 = "https://dnsmos.azurewebsites.net/v1/dnsmosp835/score"


def score_file(fpath: str, key: str | None = None, p835: bool = True) -> dict:
    """Score one wav with the web service: the P.835 endpoint (SIG, BAK,
    OVRL) or, with ``p835=False``, the P.808 one. ``key`` defaults to
    ``$DNSMOS_KEY``; without either it raises RuntimeError. Returns the
    service's JSON reply."""
    import requests

    key = key or os.environ.get("DNSMOS_KEY")
    if not key:
        raise RuntimeError("DNSMOS web scoring needs a subscription key (pass key= or set "
                           "DNSMOS_KEY)")
    with open(fpath, "rb") as f:
        payload = {"data": base64.b64encode(f.read()).decode("ascii"),
                   "filename": os.path.basename(fpath)}
    uri = SCORING_URI_DNSMOS_P835 if p835 else SCORING_URI_DNSMOS
    headers = {"Content-Type": "application/json", "Authorization": f"Basic {key}"}
    resp = requests.post(uri, json=payload, headers=headers, timeout=60)
    resp.raise_for_status()
    return resp.json()


def score_dir(testset_dir: str, key: str | None = None, p835: bool = True) -> list:
    """:func:`score_file` of every wav under ``testset_dir`` (recursively, in
    sorted order), each row ``{"filename": path, **reply}``."""
    rows = []
    for clip in sorted(glob.glob(os.path.join(testset_dir, "**", "*.wav"), recursive=True)):
        rows.append({"filename": clip, **score_file(clip, key, p835)})
    return rows
