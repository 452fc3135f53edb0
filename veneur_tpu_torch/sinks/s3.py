"""S3 flush-archive plugin with a native SigV4 signer.

The reference's s3 plugin (plugins/s3/s3.go:35 S3Post) uploads one
gzipped TSV object per flush through the AWS SDK.  This build has no
AWS SDK, so the uploader speaks the S3 REST API directly: an
AWS Signature Version 4 signed PUT over urllib.  The endpoint is
configurable (``aws_s3_endpoint``) so tests and S3-compatible stores
(minio etc.) can receive uploads; with no credentials the plugin
degrades to the local spool directory with the same key layout, for an
external shipper.

Port of ``veneur_tpu/sinks/s3.py``.
"""

from __future__ import annotations

import datetime
import gzip
import hashlib
import hmac
import io
import logging
import os
import time
import urllib.error
import urllib.parse
import urllib.request

log = logging.getLogger("veneur_tpu_torch.s3")


# ----------------------------------------------------------------------
# SigV4 (AWS Signature Version 4) request signing

def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(method: str, url: str, headers: dict[str, str],
                 payload: bytes, region: str, access_key: str,
                 secret_key: str, session_token: str = "",
                 service: str = "s3",
                 now: datetime.datetime | None = None
                 ) -> dict[str, str]:
    """Return ``headers`` plus the SigV4 ``Authorization``,
    ``x-amz-date``, ``x-amz-content-sha256`` (and session token)
    headers for the request.  Pure function of its inputs — ``now``
    is injectable for known-answer tests."""
    parts = urllib.parse.urlsplit(url)
    if now is None:
        now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()

    out = dict(headers)
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    if session_token:
        out["x-amz-security-token"] = session_token
    out.setdefault("host", parts.netloc)

    # canonical request: verbatim construction from the SigV4 spec
    signed = sorted(k.lower() for k in out)
    canonical_headers = "".join(
        f"{k}:{out[_orig(out, k)].strip()}\n" for k in signed)
    signed_headers = ";".join(signed)
    qs = urllib.parse.parse_qs(parts.query, keep_blank_values=True)
    canonical_qs = "&".join(
        "{}={}".format(urllib.parse.quote(k, safe="-_.~"),
                       urllib.parse.quote(v[0], safe="-_.~"))
        for k, v in sorted(qs.items()))
    canonical = "\n".join([
        method, urllib.parse.quote(parts.path or "/", safe="/-_.~"),
        canonical_qs, canonical_headers, signed_headers, payload_hash])

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    k = _hmac(b"AWS4" + secret_key.encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return out


def _orig(d: dict[str, str], lower: str) -> str:
    for k in d:
        if k.lower() == lower:
            return k
    raise KeyError(lower)


# ----------------------------------------------------------------------
# the plugin

class S3Plugin:
    """One gzipped TSV object per flush (reference plugins/s3/s3.go:35,
    key layout s3.go:68 <hostname>/<ts>.tsv.gz).  Uploads with SigV4
    when credentials are configured (or in AWS_* env vars); otherwise
    spools locally under the same layout."""
    name = "s3"

    def __init__(self, bucket: str, hostname: str = "",
                 region: str = "", endpoint: str = "",
                 access_key: str = "", secret_key: str = "",
                 session_token: str = "", spool_dir: str = "s3_spool",
                 timeout: float = 10.0, fmt: str = "native",
                 interval: float = 10.0):
        self.bucket = bucket
        self.hostname = hostname
        self.region = region or "us-east-1"
        self.endpoint = (endpoint.rstrip("/") or
                         f"https://s3.{self.region}.amazonaws.com")
        env = os.environ
        self.access_key = access_key or env.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = (secret_key or
                           env.get("AWS_SECRET_ACCESS_KEY", ""))
        self.session_token = (session_token or
                              env.get("AWS_SESSION_TOKEN", ""))
        self.spool_dir = spool_dir
        self.timeout = timeout
        self.fmt = fmt
        self.interval = interval
        self.errors = 0

    def _key(self, host: str) -> str:
        return f"{host}/{int(time.time() * 1e9)}.tsv.gz"

    def flush(self, metrics: list, hostname: str = "") -> None:
        from veneur_tpu_torch.sinks.simple import encode_flush_rows
        host = hostname or self.hostname or "unknown"
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb") as gz:
            gz.write(encode_flush_rows(metrics, host, self.fmt,
                                       self.interval).encode())
        body = buf.getvalue()
        key = self._key(host)
        if self.access_key and self.secret_key:
            try:
                self._upload(key, body)
                return
            except (urllib.error.URLError, OSError) as e:
                # drop to the spool — an interval archive is better
                # late than lost (the reference only logs, s3.go:59)
                self.errors += 1
                log.warning("s3 upload failed (%s); spooling %s", e,
                            key)
        self._spool(key, body)

    def _upload(self, key: str, body: bytes) -> None:
        # path-style addressing: endpoint/bucket/key — works for both
        # AWS and S3-compatible endpoints without DNS games
        url = f"{self.endpoint}/{self.bucket}/{key}"
        headers = sign_request(
            "PUT", url, {"content-type": "application/gzip"}, body,
            self.region, self.access_key, self.secret_key,
            self.session_token)
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()

    def _spool(self, key: str, body: bytes) -> None:
        path = os.path.join(self.spool_dir, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(body)
