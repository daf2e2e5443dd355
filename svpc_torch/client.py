"""Python client for the caption serving daemon (cli/serve.py): the port of
svpc_tpu/client.py.

Stdlib-only (urllib): usable from any environment that can reach the
daemon (svpc_torch.cli.serve, or svpc_tpu's, which speaks the same API),
including feature-extraction hosts that have no torch.

    from svpc_torch.client import CaptionClient
    client = CaptionClient("http://localhost:8700")
    client.health()
    client.caption("videoX", timestamps=[[0.0, 12.5], [12.5, 40.1]],
                   ingredients=["olive oil", "chicken breast"])
    # features not staged on the serving host? upload them inline:
    client.caption("videoY", timestamps=[[0.0, 9.0]], ingredients=[],
                   resnet=resnet_array, bn=bn_array,
                   duration=180.0, n_frames=5400)
"""

from __future__ import annotations

import base64
import io
import json
import urllib.error
import urllib.request
from typing import Optional, Sequence


class CaptionClientError(RuntimeError):
    """Daemon-reported failure; carries the HTTP status code."""

    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        self.message = message


def _b64_npy(array) -> str:
    buf = io.BytesIO()
    import numpy as np
    np.save(buf, np.ascontiguousarray(array))
    return base64.b64encode(buf.getvalue()).decode()


class CaptionClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            try:
                message = json.load(e).get("error", "")
            except Exception:
                message = e.reason
            raise CaptionClientError(e.code, message) from None

    def health(self) -> dict:
        return self._request("/healthz")

    def stats(self) -> dict:
        return self._request("/v1/stats")

    def caption(self, video_id: str, timestamps: Sequence[Sequence[float]],
                ingredients: Sequence[str] = (),
                resnet=None, bn=None,
                duration: Optional[float] = None,
                n_frames: Optional[float] = None) -> dict:
        """Caption one video -> the daemon's response dict
        ({'video_id', 'captions': [{'timestamp', 'sentence'}, ...],
        'truncated_clips'?}).

        Pass ``resnet``/``bn`` numpy arrays (plus ``duration`` seconds and
        the extraction ``n_frames``) to upload the features inline when
        they are not staged on the serving host."""
        payload = {"video_id": video_id,
                   "timestamps": [list(t) for t in timestamps],
                   "ingredients": list(ingredients)}
        if resnet is not None or bn is not None:
            if resnet is None or bn is None:
                raise ValueError("feature upload needs BOTH resnet and bn")
            payload["features"] = {"resnet": _b64_npy(resnet),
                                   "bn": _b64_npy(bn)}
            payload["duration"] = duration
            payload["n_frames"] = n_frames
        return self._request("/v1/captions", payload)
