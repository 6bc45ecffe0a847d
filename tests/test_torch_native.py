"""The port's native host loaders (``ttsx_torch.native``: the wav decoder
and the pthreads prefetcher) against ``ttsx.native``'s and the scipy
route, and their build.

The port builds its own copy of the C sources at first use into
``ttsx_torch/_build/native-<hash>/``; the reference's extensions are
``ttsx.native.wavio`` / ``ttsx.native.prefetch``. Same sources, same
compiler: the port's decoder and prefetcher give the reference's
samples and batches bit for bit. No process group is needed here.
"""
import struct

import numpy as np
import pytest

SR = 16000


def _riff(path, fmt_tag, channels, bits, raw, sr=SR, extensible=False):
    """A RIFF/WAVE file of ``raw`` sample bytes, ``fmt_tag`` (wrapped in
    WAVE_FORMAT_EXTENSIBLE when asked)."""
    block = channels * bits // 8
    if extensible:
        sub = struct.pack("<H", fmt_tag) + bytes(14)
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block,
                          block, bits, 22, bits, 0) + sub
    else:
        fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr, sr * block,
                          block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"      # skipped
            + b"data" + struct.pack("<I", len(raw)) + raw)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _signal(n, channels, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.5 * np.sin(2 * np.pi * 220 * t)[:, None] + 0.2 * rng.normal(
        size=(n, channels))
    return np.clip(x, -0.999, 0.999)


def _encode(kind, x):
    """(format tag, bits, bytes) of ``x`` [n, channels] in ``kind``."""
    if kind == "u8":
        return 1, 8, (x * 127 + 128).astype(np.uint8).tobytes()
    if kind == "s16":
        return 1, 16, (x * 32767).astype("<i2").tobytes()
    if kind == "s24":
        v = (x * 8388607).astype(np.int32).reshape(-1)
        return 1, 24, b"".join(int(s & 0xFFFFFF).to_bytes(3, "little")
                               for s in v)
    if kind == "s32":
        return 1, 32, (x * 2147483647).astype("<i4").tobytes()
    if kind == "f32":
        return 3, 32, x.astype("<f4").tobytes()
    if kind == "f64":
        return 3, 64, x.astype("<f8").tobytes()
    raise ValueError(kind)


ENCODINGS = ["u8", "s16", "s24", "s32", "f32", "f64"]


@pytest.mark.parametrize("extensible", [False, True])
@pytest.mark.parametrize("kind", ENCODINGS)
def test_decoder_bit_equal_to_reference(tmp_path, kind, extensible):
    """Every encoding, mono and stereo, at the file's rate and resampled
    up and down: the port's decoder gives the reference's samples bit for
    bit."""
    from ttsx.native import wavio as jwavio
    from ttsx_torch.native import load
    wavio = load("_ttsx_wavio")
    if jwavio is None:
        pytest.skip("the reference's extension did not build")
    for channels in (1, 2):
        tag, bits, raw = _encode(kind, _signal(2001, channels))
        p = _riff(tmp_path / f"{kind}{channels}.wav", tag, channels, bits,
                  raw, extensible=extensible)
        for sr in (0, 8000, 22050):
            got, got_sr = wavio.read_wav(str(p), sr)
            ref, ref_sr = jwavio.read_wav(str(p), sr)
            assert got_sr == ref_sr == (sr or SR)
            assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_read_wav_takes_the_native_decoder_and_matches_scipy(tmp_path,
                                                            monkeypatch):
    """``read_wav`` returns the native decoder's samples; the scipy route
    (the decoder made unavailable) gives the same samples: bit for bit
    for mono PCM and float at the file's rate, within 1e-6 where the
    routes mix channels or resample in another order (as the reference's
    own test holds its routes)."""
    from scipy.io import wavfile
    import ttsx_torch.native as native
    from ttsx_torch.data.dataset import read_wav
    x = _signal(3001, 2, seed=1)
    paths = {}
    for name, data in (("s16", (x[:, 0] * 32767).astype(np.int16)),
                       ("s32", (x[:, 0] * 2147483647).astype(np.int32)),
                       ("u8", (x[:, 0] * 127 + 128).astype(np.uint8)),
                       ("f32", x[:, 0].astype(np.float32)),
                       ("s16_stereo", (x * 32767).astype(np.int16))):
        paths[name] = tmp_path / f"{name}.wav"
        wavfile.write(paths[name], SR, data)
    wavio = native.load("_ttsx_wavio")
    got = {(n, sr): read_wav(p, sr) for n, p in paths.items()
           for sr in (None, 22050)}
    for (n, sr), (w, s) in got.items():
        nat, nat_sr = wavio.read_wav(str(paths[n]), sr or 0)
        assert s == nat_sr and np.array_equal(w, nat)
    monkeypatch.setattr(native, "try_load", lambda name: None)
    for (n, sr), (w, s) in got.items():
        sp, sp_sr = read_wav(paths[n], sr)
        assert sp_sr == s and sp.dtype == np.float32
        if sr is None and "stereo" not in n:
            assert np.array_equal(w, sp), n
        else:
            np.testing.assert_allclose(w, sp, rtol=0, atol=1e-6, err_msg=n)


def test_unsupported_encoding_goes_to_scipy(tmp_path):
    """64-bit PCM: the decoder refuses it, ``read_wav`` reads it through
    scipy, as the reference's does."""
    from scipy.io import wavfile
    from ttsx.data.dataset import read_wav as jread
    from ttsx_torch.data.dataset import read_wav
    from ttsx_torch.native import load
    p = tmp_path / "s64.wav"
    wavfile.write(p, SR, (_signal(500, 1)[:, 0] * 1e6).astype(np.int64))
    with pytest.raises(ValueError, match="unsupported encoding"):
        load("_ttsx_wavio").read_wav(str(p))
    got, sr = read_wav(p)
    ref, ref_sr = jread(p)
    assert sr == ref_sr == SR and np.array_equal(got, ref)


def _constant_files(tmp_path, n=5):
    from ttsx_torch.data.dataset import write_wav
    items = []
    for i in range(n):
        p = tmp_path / f"f{i}.wav"
        write_wav(p, np.full(3000 + 200 * i, (i + 1) / 10.0, np.float32), SR)
        items.append((str(p), i))
    return items


def test_prefetcher_batches_equal_reference(tmp_path):
    """``WavBatchLoader`` takes the native pthreads executor by default;
    with one worker and the reference's native loader's seed, the same
    batches bit for bit (crops, padding, labels); label/content
    alignment, seed determinism and clean shutdown, as
    tests/test_data.py holds the reference's."""
    from ttsx import native as jnative
    from ttsx.data import WavBatchLoader as J
    from ttsx_torch.data import WavBatchLoader
    if jnative.prefetch is None:
        pytest.skip("the reference's extension did not build")
    items = _constant_files(tmp_path)
    short = tmp_path / "short.wav"
    from ttsx_torch.data.dataset import write_wav
    write_wav(short, np.full(500, 0.7, np.float32), SR)
    items.append((str(short), 9))
    kw = dict(crop=2048, batch=3, workers=1, depth=2, seed=7)
    with WavBatchLoader(items, **kw) as got, J(items, native=True,
                                               **kw) as ref:
        assert got.is_native and ref.is_native
        gb = [got.next(10000) for _ in range(4)]
        rb = [ref.next(10000) for _ in range(4)]
        produced, consumed, errors = got.stats()
    for (gw, gl), (rw, rl) in zip(gb, rb):
        assert gw.shape == (3, 2048) and gw.dtype == np.float32
        assert gl.shape == (3,) and gl.dtype == np.int32
        assert np.array_equal(gw, rw) and np.array_equal(gl, rl)
        for b in range(3):
            level = 0.7 if gl[b] == 9 else (gl[b] + 1) / 10.0
            assert abs(gw[b].max() - level) < 2e-2
            if gl[b] == 9:
                assert not gw[b, 500:].any()        # zero-padded
    assert consumed == 4 and produced >= consumed and errors == 0
    with WavBatchLoader(items, **kw) as again:
        assert all(np.array_equal(a, b) for a, b in
                   zip(again.next(10000), gb[0]))


def test_failed_build_raises_for_native_true(tmp_path, monkeypatch):
    """A compiler that fails: ``native=True`` raises with its error, the
    default takes the Python executor (``is_native`` False) and
    ``read_wav`` the scipy route; the build writes only under its build
    root, never beside the sources."""
    import ttsx_torch.native as native
    from ttsx_torch.data import WavBatchLoader, read_wav
    items = _constant_files(tmp_path, 2)
    before = sorted(p.name for p in native.HERE.iterdir())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(native.NativeBuildError, match="no-such-cc"):
        WavBatchLoader(items, crop=100, batch=2, native=True)
    with WavBatchLoader(items, crop=100, batch=2, workers=1) as loader:
        assert not loader.is_native
        assert loader.next(10000)[0].shape == (2, 100)
    wav, sr = read_wav(items[0][0])
    assert sr == SR and len(wav) == 3000
    # a compiler that runs and fails: its stderr is in the error
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("CC", "gcc")
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ["-DNO_SUCH",
                                                           "-include",
                                                           "no_such.h"])
    with pytest.raises(RuntimeError, match="no_such.h"):
        WavBatchLoader(items, crop=100, batch=2, native=True)
    assert sorted(p.name for p in native.HERE.iterdir()) == before
    monkeypatch.undo()
    # the real build: under ttsx_torch/_build/native-<hash>/ only
    assert native.build_dir().parent == native.HERE.parent / "_build"
    for name, path in native.build_all().items():
        assert path.parent == native.build_dir() and path.exists()
