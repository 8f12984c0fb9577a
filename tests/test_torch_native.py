"""The port's native components (channeld_tpu_torch/native).

- The framing + snappy codec is built from the port's own ``codec.cc``
  at first import (``native.build_codec``), and the port's framing takes
  it: its frames are byte-identical to the port's pure-Python path and
  to the JAX package's ``_codec`` on the same seeded inputs.
- ``kcp_peer`` built from the port's copy speaks KCP with the port's
  ``core/kcp.py``, both ways, over real UDP sockets.

Like the JAX package's tests, these skip only where g++ or
libsnappy.so.1 is absent (the codec cannot be built there).
"""

from __future__ import annotations

import random
import shutil
import subprocess
import threading
from pathlib import Path

import pytest

from channeld_tpu_torch import native
from channeld_tpu_torch.core.kcp import KcpClient
from channeld_tpu_torch.protocol import framing
from channeld_tpu_torch.protocol.framing import FrameDecoder, encode_frame

from test_kcp_interop import (
    LossyUdpProxy,
    _free_port,
    _pump_echo,
    _run_python_echo_server,
    _spawn_echo,
)

HAVE_TOOLCHAIN = shutil.which("g++") is not None and any(
    Path(d, "libsnappy.so.1").exists()
    for d in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib", "/lib/x86_64-linux-gnu"))
pytestmark = pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no g++ or libsnappy.so.1")


def bodies(seed: int) -> list[bytes]:
    rng = random.Random(seed)
    return ([b"", b"\x00", bytes(rng.randrange(256) for _ in range(rng.randrange(1, 400)))]
            + [bytes(200) for _ in range(2)]  # compressible
            + [rng.randbytes(rng.randrange(0, 3000)) for _ in range(20)])


def jax_codec():
    from channeld_tpu.native import codec

    if codec is None:
        pytest.skip("the JAX package's codec is not built")
    return codec


def test_codec_is_built_from_the_ports_source():
    assert native.codec is not None
    path = Path(native.codec.__file__)
    assert path == native.build_codec()  # the cached build of today's codec.cc
    assert path.parent == native.BUILD_DIR
    assert framing._native is native.codec
    assert native.codec.__name__ == "channeld_tpu_torch.native._codec"


@pytest.mark.parametrize("compression", [0, 1])
def test_encode_frame_equals_pure_python_and_the_jax_codec(monkeypatch, compression):
    jax = jax_codec()
    for body in bodies(3):
        built = encode_frame(body, compression)
        assert built == native.codec.encode_frame(body, compression)
        assert built == jax.encode_frame(body, compression)
        monkeypatch.setattr(framing, "_native", None)
        assert encode_frame(body, compression) == built, len(body)
        monkeypatch.undo()


def test_decode_frames_equals_pure_python_fragmented(monkeypatch):
    """One byte stream, chopped at seeded points, yields the same frames
    from the native decoder, the pure-Python one and the JAX codec's."""
    rng = random.Random(9)
    stream = b"".join(encode_frame(rng.randbytes(rng.randrange(0, 300)), rng.randrange(2))
                      for _ in range(20))
    cuts = sorted(rng.randrange(len(stream)) for _ in range(15)) + [len(stream)]
    chunks, pos = [], 0
    for c in cuts:
        chunks.append(stream[pos:c])
        pos = c

    def decode():
        dec = FrameDecoder()
        return [f for chunk in chunks for f in dec.feed(chunk)]

    native_frames = decode()
    monkeypatch.setattr(framing, "_native", jax_codec())
    jax_frames = decode()
    monkeypatch.setattr(framing, "_native", None)
    pure_frames = decode()
    assert native_frames == pure_frames == jax_frames
    assert len(native_frames) == 20


def test_encode_packets_equals_pure_python_and_the_jax_codec():
    from channeld_tpu_torch.core.connection import Connection
    from channeld_tpu_torch.core.types import ConnectionType

    from helpers import FakeTransport

    rng = random.Random(4)
    batch = [(rng.randrange(0, 1 << 20), rng.randrange(0, 128), rng.randrange(0, 1 << 16),
              rng.randrange(1, 200), rng.randbytes(rng.randrange(0, 3000))) for _ in range(60)]
    batch.insert(10, (1, 0, 0, 8, bytes(40_000)))  # multi-frame splits
    batch.insert(30, (2, 3, 1, 8, bytes(50_000)))
    conn = Connection(1, ConnectionType.CLIENT, FakeTransport(), None)
    jax = jax_codec()
    for ct in (0, 1):
        frames, counts = native.codec.encode_packets(batch, ct)
        pure_frames, pure_counts = conn._encode_packets_py(batch, ct)
        jax_frames, jax_counts = jax.encode_packets(batch, ct)
        assert list(counts) == list(pure_counts) == list(jax_counts), ct
        assert list(frames) == list(pure_frames) == list(jax_frames), ct


@pytest.fixture(scope="module")
def peer_bin():
    return str(native.build_kcp_peer())


def test_kcp_peer_is_built_from_the_ports_source(peer_bin):
    assert Path(peer_bin).parent == native.BUILD_DIR
    assert Path(peer_bin).name.startswith("kcp_peer-")


def test_port_kcp_client_to_c_server(peer_bin):
    port = _free_port()
    proc = _spawn_echo(peer_bin, port)
    try:
        client = KcpClient("127.0.0.1", port, timeout=1.0)
        payload = random.Random(7).randbytes(96 * 1024)
        assert _pump_echo(client, payload) == payload
        client.close()
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("lossy", [False, True], ids=["clean", "lossy"])
def test_c_client_to_port_kcp_server(peer_bin, lossy, monkeypatch):
    """The C peer streams to the port's KcpServerProtocol (the gateway's
    UDP listener) and reads the echo back, clean and under loss."""
    import test_kcp_interop
    from channeld_tpu_torch.core import kcp

    monkeypatch.setattr(test_kcp_interop, "KcpServerProtocol", kcp.KcpServerProtocol)
    port = _free_port()
    stop, ready, errors = threading.Event(), threading.Event(), []
    server = threading.Thread(target=_run_python_echo_server,
                              args=(port, stop, ready, errors), daemon=True)
    server.start()
    assert ready.wait(timeout=5) and not errors, errors
    proxy = LossyUdpProxy(("127.0.0.1", port), seed=1337) if lossy else None
    try:
        nbytes = 48 * 1024 if lossy else 96 * 1024
        proc = subprocess.run(
            [peer_bin, "send", "127.0.0.1", str(proxy.port if proxy else port), str(nbytes),
             "90210"], capture_output=True, text=True, timeout=90)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert proc.stdout.strip() == f"OK {nbytes}"
    finally:
        if proxy:
            proxy.close()
        stop.set()
        server.join(timeout=3)
