"""Minimal separation service: HTTP control plane over the jitted pipeline.

Production-deployment counterpart of the reference's two applications: POST
audio, receive separated stems. Compute runs through the same compiled
graphs as the CLI (compile once at startup, then every request reuses the
executable); the host side only decodes/encodes audio.

Endpoints:
- GET  /healthz            -> {"status": "ok", "devices": N}
- POST /separate           -> WAV body in; multichannel WAV out
                              (stem-major channel pairs, fs 44100)
  Query params: stems (2|3|4|5, default from server config),
                format (wav8ch | npz)
- POST /separate_batch     -> NPZ body of float32 tracks (each (2, n) or
                              (n,) at 44.1 kHz) in; NPZ of
                              "{track}/{stem}" arrays out. All tracks run
                              in ONE device dispatch via the multi-track
                              sharded path (parallel.mesh
                              .separate_batch_sharded) -- the batched
                              counterpart of the reference's one-song CLI.

Failure contract: malformed input (bad codec bytes, bad params, wrong
shapes) -> 400; oversized body -> 413; internal faults -> 500 with a
generic message (details go to the server log, not the client).

Run: python -m spleeterrt_tpu.runtime.server --port 8080 --random-weights
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
from zlib import error as _zlib_error

# Errors attributable to the request body/params (-> HTTP 400). Everything
# else is an internal fault (-> HTTP 500).
CLIENT_ERRORS = (ValueError, KeyError, EOFError, struct.error, _zlib_error)


class SeparationService:
    """Holds weights + config; thread-safe separate() over the jit cache."""

    def __init__(self, cfg, weight_kwargs: dict, max_body_bytes: int = 1 << 28):
        self.cfg = cfg
        self.weight_kwargs = weight_kwargs
        self.max_body_bytes = max_body_bytes
        self._lock = threading.Lock()

    def separate_wav(self, wav_bytes: bytes, num_stems: int | None = None):
        import dataclasses

        import jax.numpy as jnp

        from spleeterrt_tpu.core import separate
        from spleeterrt_tpu.io import audio as audio_io, resample

        cfg = self.cfg
        if num_stems and num_stems != cfg.num_stems:
            cfg = dataclasses.replace(cfg, num_stems=num_stems)
        data = audio_io.read_wav(wav_bytes)
        x = data.samples
        if data.sample_rate != 44100:
            x = resample.resample(x, data.sample_rate, 44100)
        if x.shape[0] == 1:
            x = np.repeat(x, 2, axis=0)
        # XLA compilation/execution is internally synchronized, but keep
        # request ordering deterministic for the single-chip case.
        with self._lock:
            stems = separate.separate(x[:2], cfg=cfg, **self.weight_kwargs)
        return {k: np.asarray(v) for k, v in stems.items()}

    def separate_batch(self, npz_bytes: bytes) -> dict[str, np.ndarray]:
        """All tracks of an NPZ body through ONE sharded multi-track dispatch.

        Returns {"{track}/{stem}": (2, n_track) float32}. Only the stacked
        N-stem graphs (4/5 stems) support the batched path; see
        parallel.mesh.separate_batch_sharded.
        """
        import jax

        from spleeterrt_tpu.core import transform
        from spleeterrt_tpu.parallel.mesh import make_mesh, separate_batch_sharded

        stacked = self.weight_kwargs.get("stacked_params")
        if stacked is None:
            raise ValueError(
                f"batch endpoint requires a 4/5-stem server (got "
                f"{self.cfg.num_stems}-stem weights)"
            )
        with np.load(io.BytesIO(npz_bytes), allow_pickle=False) as z:
            names = list(z.files)
            if not names:
                raise ValueError("empty NPZ: no tracks")
            tracks = {}
            for name in names:
                x = np.asarray(z[name], np.float32)
                if x.ndim == 1:
                    x = np.stack([x, x])
                if x.ndim != 2 or x.shape[0] not in (1, 2):
                    raise ValueError(
                        f"track {name!r}: expected (2, n) or (n,), got {x.shape}"
                    )
                if x.shape[0] == 1:
                    x = np.repeat(x, 2, axis=0)
                tracks[name] = x
        lengths = {k: v.shape[-1] for k, v in tracks.items()}
        n_max = max(lengths.values())
        batch = np.stack(
            [np.pad(v, ((0, 0), (0, n_max - v.shape[-1]))) for v in tracks.values()]
        )
        preshift, _ = transform.offline_pad_sizes(n_max, self.cfg.transform)
        padded = transform.pad_offline(batch, self.cfg.transform)
        with self._lock:
            mesh = make_mesh(jax.devices(), stem_parallel=1)
            n_data = mesh.shape["data"]
            n_tracks = padded.shape[0]
            pad_tracks = -(-n_tracks // n_data) * n_data - n_tracks
            if pad_tracks:  # "data"-axis sharding needs an even split
                padded = np.pad(padded, ((0, pad_tracks), (0, 0), (0, 0)))
            out = np.asarray(
                separate_batch_sharded(stacked, padded, self.cfg, mesh)
            )[:n_tracks]
        result = {}
        for i, name in enumerate(tracks):
            for s, stem in enumerate(self.cfg.stem_names):
                result[f"{name}/{stem}"] = out[
                    i, s, :, preshift : preshift + lengths[name]
                ]
        return result


def _make_handler(service: SeparationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet test runs
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                import jax

                body = json.dumps(
                    {"status": "ok", "devices": len(jax.devices())}
                ).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _read_body(self) -> bytes | None:
            length = int(self.headers.get("Content-Length", 0))
            if length > service.max_body_bytes:
                self._send(
                    413,
                    f"body {length} B exceeds cap {service.max_body_bytes} B".encode(),
                    "text/plain",
                )
                return None
            return self.rfile.read(length)

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            if parsed.path == "/separate_batch":
                body = self._read_body()
                if body is None:
                    return
                try:
                    out = service.separate_batch(body)
                except CLIENT_ERRORS as e:
                    self._send(400, str(e).encode(), "text/plain")
                    return
                except Exception:
                    traceback.print_exc()
                    self._send(500, b"internal separation error", "text/plain")
                    return
                buf = io.BytesIO()
                np.savez(buf, **out)
                self._send(200, buf.getvalue(), "application/octet-stream")
                return
            if parsed.path != "/separate":
                self._send(404, b"not found", "text/plain")
                return
            q = parse_qs(parsed.query)
            try:
                stems_n = int(q.get("stems", [0])[0]) or None
            except ValueError:
                self._send(400, b"stems must be an integer", "text/plain")
                return
            fmt = q.get("format", ["wav8ch"])[0]
            body = self._read_body()
            if body is None:
                return
            try:
                stems = service.separate_wav(body, stems_n)
            except CLIENT_ERRORS as e:  # decode/shape errors are the client's
                self._send(400, str(e).encode(), "text/plain")
                return
            except Exception:  # internal faults are ours: 500, log the trace
                traceback.print_exc()
                self._send(500, b"internal separation error", "text/plain")
                return
            if fmt == "npz":
                buf = io.BytesIO()
                np.savez(buf, **stems)
                self._send(200, buf.getvalue(), "application/octet-stream")
                return
            from spleeterrt_tpu.io import audio as audio_io
            import tempfile, os

            multi = np.concatenate(list(stems.values()), axis=0)
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                path = f.name
            try:
                audio_io.write_wav(path, multi, 44100)
                with open(path, "rb") as f:
                    body = f.read()
            finally:
                os.unlink(path)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("X-Stem-Order", ",".join(stems.keys()))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def make_server(host: str, port: int, service: SeparationService):
    return ThreadingHTTPServer((host, port), _make_handler(service))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spleeterrt-tpu-server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--stems", type=int, default=4, choices=(2, 3, 4, 5))
    ap.add_argument("--time-step", type=int, default=256)
    ap.add_argument("--bin-limit", type=int, default=1536)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--max-body-mb", type=int, default=256,
        help="reject request bodies larger than this (HTTP 413)",
    )
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from spleeterrt_tpu import cli
    from spleeterrt_tpu.config import SeparatorConfig
    from spleeterrt_tpu.core import platform

    platform.enable_compile_cache()
    print(f"backend: {platform.backend()}")
    cfg = SeparatorConfig(
        bin_limit=args.bin_limit // 64 * 64,
        time_step=max(64, args.time_step // 64 * 64),
        num_stems=args.stems,
        compute_dtype=jnp.bfloat16,
    )
    weight_kwargs = cli._load_weights(args, cfg)
    service = SeparationService(
        cfg, weight_kwargs, max_body_bytes=args.max_body_mb << 20
    )
    srv = make_server(args.host, args.port, service)
    print(f"serving on http://{args.host}:{args.port}")
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
