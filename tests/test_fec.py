"""FEC layer tests: Hamming(7,4) (north star) and RS(255,223) (parity)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_tpu.fec import hamming
from ofdm_tpu.fec import reed_solomon as rs


class TestHamming:
    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        data = jnp.asarray(rng.integers(0, 256, 200, dtype=np.uint8))
        coded = hamming.encode(data)
        assert coded.shape[0] == hamming.encoded_len(200) == 350
        back = hamming.decode(coded, 200)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(data))

    def test_corrects_one_bit_per_codeword(self):
        rng = np.random.default_rng(1)
        data = jnp.asarray(rng.integers(0, 256, 64, dtype=np.uint8))
        coded = np.asarray(hamming.encode(data)).copy()
        # flip one bit inside each of several distinct codewords (7-bit each)
        coded_bits = np.unpackbits(coded, bitorder="little")
        for cw in range(0, 128, 3):
            bitpos = cw * 7 + (cw % 7)
            coded_bits[bitpos] ^= 1
        corrupted = np.packbits(coded_bits, bitorder="little")
        back = hamming.decode(jnp.asarray(corrupted), 64)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(data))

    def test_batched(self):
        rng = np.random.default_rng(2)
        data = jnp.asarray(rng.integers(0, 256, (4, 50), dtype=np.uint8))
        back = hamming.decode(hamming.encode(data), 50)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(data))


class TestReedSolomon:
    def test_generator_poly_first_coeffs(self):
        # g(x) = prod (x - a^i), i=0..31; degree 32, monic.
        assert len(rs._GEN) == 33 and rs._GEN[0] == 1
        # known for 0x11d, fcr=0: g has all-nonzero coefficients
        assert (rs._GEN != 0).all()

    def test_stream_framing_matches_reference(self):
        # len % 223 == 0 still emits a trailing all-zero block
        # (src/utils.rs:123-131 None arm).
        coded = rs.encode_stream(np.zeros(223, np.uint8))
        assert len(coded) == 2 * 255
        coded = rs.encode_stream(np.zeros(10, np.uint8))
        assert len(coded) == 255

    def test_clean_roundtrip(self):
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, 1024, dtype=np.uint8)
        back, ok = rs.decode_stream(rs.encode_stream(data))
        assert ok
        np.testing.assert_array_equal(back[:1024], data)
        # decode pads to whole blocks: trailing zeros beyond the data
        assert (back[1024:] == 0).all()

    @pytest.mark.parametrize("nerr", [1, 4, 16])
    def test_corrects_up_to_16_byte_errors(self, nerr):
        rng = np.random.default_rng(nerr)
        data = rng.integers(0, 256, 300, dtype=np.uint8)
        coded = rs.encode_stream(data).copy()
        pos = rng.choice(255, nerr, replace=False)
        coded[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
        back, ok = rs.decode_stream(coded)
        assert ok
        np.testing.assert_array_equal(back[:300], data)

    def test_17_errors_fail_or_mismatch(self):
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, 300, dtype=np.uint8)
        coded = rs.encode_stream(data).copy()
        pos = rng.choice(255, 20, replace=False)
        coded[pos] ^= rng.integers(1, 256, 20).astype(np.uint8)
        back, ok = rs.decode_stream(coded)
        assert (not ok) or (not np.array_equal(back[:300], data))

    def test_zero_codeword_is_valid(self):
        # all-zero 255 block is a codeword; decode succeeds with zero data —
        # this is why the reference's trailing-block quirk is harmless.
        back, ok = rs.decode_blocks(np.zeros((1, 255), np.uint8))
        assert ok.all() and (back == 0).all()

    def test_errors_in_different_blocks(self):
        rng = np.random.default_rng(11)
        data = rng.integers(0, 256, 600, dtype=np.uint8)  # 3 blocks
        coded = rs.encode_stream(data).copy()
        for blk in range(3):
            pos = blk * 255 + rng.choice(255, 10, replace=False)
            coded[pos] ^= rng.integers(1, 256, 10).astype(np.uint8)
        back, ok = rs.decode_stream(coded)
        assert ok
        np.testing.assert_array_equal(back[:600], data)

    @pytest.mark.skipif(rs._LIB is None, reason="native codec not built")
    def test_native_selftest(self):
        # Locks the GF(0x11d)->GF(0x11b) isomorphism and the GFNI instruction
        # conventions the vectorized error path relies on (native/rs_codec.cpp
        # correct_batch64); stage codes documented at rs_selftest.
        import ctypes
        rs._LIB.rs_selftest.restype = ctypes.c_int
        assert rs._LIB.rs_selftest() == 0

    def test_native_threads_none_without_the_library(self, monkeypatch):
        monkeypatch.setattr(rs, "_LIB", None)
        assert rs.native_threads() is None

    @pytest.mark.parametrize("openmp", [True, False])
    def test_native_threads_reports_the_build(self, tmp_path, openmp):
        """rs_threads() is OpenMP's thread count in an OpenMP build and 1 in
        the build native/Makefile makes where libgomp is missing.  Loaded
        in a child process, which reads OMP_NUM_THREADS at start."""
        import shutil
        import subprocess
        native = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "native")
        for name in ("Makefile", "rs_codec.cpp"):
            shutil.copy(os.path.join(native, name), tmp_path / name)
        flags = "-O2 -fPIC -std=c++17 " + (
            "-fopenmp" if openmp else "-Wno-unknown-pragmas")
        env = dict(os.environ, OMP_NUM_THREADS="3")
        subprocess.run(["make", "-C", str(tmp_path), "librs_codec.so",
                        f"CXXFLAGS={flags}"], check=True, env=env,
                       capture_output=True, timeout=300)
        probe = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
                 "print(lib.rs_threads(), lib.rs_selftest())")
        out = subprocess.run(
            [sys.executable, "-c", probe, str(tmp_path / "librs_codec.so")],
            check=True, env=env, capture_output=True, text=True, timeout=60)
        assert out.stdout.split() == ["3" if openmp else "1", "0"]

    @pytest.mark.skipif(rs._LIB is None, reason="native codec not built")
    def test_native_matches_python_oracle_mixed_errors(self):
        # The SoA GFNI error path (64 blocks per tile, branchless BM/Chien/
        # Forney) must agree with the pure-python scalar decoder on ok flags
        # AND corrected bytes across the whole 0..t..beyond-t range, including
        # lanes that fail inside a tile of successes.
        rng = np.random.default_rng(123)
        nb = 192  # 3 tiles
        data = rng.integers(0, 256, (nb, rs.K), dtype=np.uint8)
        coded = rs.encode_blocks(data)
        nerrs = rng.integers(0, 21, nb)
        c = coded.copy()
        for i in range(nb):
            ne = nerrs[i]
            if ne == 0:
                continue
            pos = rng.choice(rs.N, ne, replace=False)
            c[i, pos] ^= rng.integers(1, 256, ne, dtype=np.uint8)
        out, ok = rs.decode_blocks(c)
        lib = rs._LIB
        try:
            rs._LIB = None
            out_py, ok_py = rs.decode_blocks(c)
        finally:
            rs._LIB = lib
        np.testing.assert_array_equal(ok, ok_py)
        np.testing.assert_array_equal(out[ok], out_py[ok_py])
        assert ok[nerrs <= rs.ECC // 2].all()
        np.testing.assert_array_equal(out[nerrs <= rs.ECC // 2],
                                      data[nerrs <= rs.ECC // 2])
        assert not ok[nerrs > rs.ECC // 2].any()

    def test_decode_payload_rows_matches_per_row_stream(self):
        # The batched row decoder (ONE codec call for a whole capture buffer)
        # must equal decode_stream applied per row — bytes and ok flags —
        # including corrected rows and an uncorrectable row.
        rng = np.random.default_rng(321)
        n_bytes = 500                     # 3 blocks/row incl. trailing block
        rows_data = rng.integers(0, 256, (6, n_bytes), dtype=np.uint8)
        coded = np.stack([rs.encode_stream(r) for r in rows_data])
        # row 1: 16 errors in block 0 (correctable); row 3: 17 (not)
        coded[1, rng.choice(255, 16, replace=False)] ^= 0x5A
        coded[3, rng.choice(255, 17, replace=False)] ^= 0xA5
        got, ok = rs.decode_payload_rows(coded, n_bytes)
        for i in range(6):
            ref, ref_ok = rs.decode_stream(coded[i])
            assert bool(ok[i]) == ref_ok
            np.testing.assert_array_equal(got[i], ref[:n_bytes])
        np.testing.assert_array_equal(got[ok], rows_data[ok])
        assert not ok[3]


class TestEndToEndWithFec:
    """FEC composed with the modem: the lab3b_image/lab3c configuration."""

    def test_rs_over_noisy_channel(self):
        import jax
        import ofdm_tpu as ot
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, 400, dtype=np.uint8)
        coded = rs.encode_stream(data)
        tx = ot.encode(coded, guard_bands=True, modulation=ot.Modulation.QPSK,
                       dtype=jnp.complex128)
        rx = ot.channel(tx, snr=15.0, timing_error=True, key=jax.random.key(1))
        out = ot.decode(rx, guard_bands=True, modulation=ot.Modulation.QPSK)
        back, ok = rs.decode_stream(out)
        assert ok
        np.testing.assert_array_equal(back[:400], data)

    def test_hamming_over_noisy_channel(self):
        import jax
        import ofdm_tpu as ot
        rng = np.random.default_rng(6)
        data = jnp.asarray(rng.integers(0, 256, 400, dtype=np.uint8))
        coded = hamming.encode(data)
        tx = ot.encode(np.asarray(coded), guard_bands=True,
                       modulation=ot.Modulation.QPSK, dtype=jnp.complex128)
        rx = ot.channel(tx, snr=14.0, timing_error=False, key=jax.random.key(2))
        out = ot.decode(rx, guard_bands=True, modulation=ot.Modulation.QPSK)
        back = hamming.decode(jnp.asarray(out), 400)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(data))


class TestHammingWireFormat:
    """Lock the SoA bit-math codec to an independent bit-tensor reference
    (the spec in hamming.py's docstring, straight-line numpy)."""

    @staticmethod
    def _ref_encode(data):
        from ofdm_tpu.fec.hamming import _G
        bits = np.unpackbits(data, bitorder="little")
        nibbles = bits.reshape(-1, 4)
        code = (nibbles @ _G) % 2
        flat = code.reshape(-1)
        pad = (-flat.shape[0]) % 8
        return np.packbits(np.pad(flat, (0, pad)), bitorder="little")

    @staticmethod
    def _ref_decode(coded, n_bytes):
        from ofdm_tpu.fec.hamming import _H
        bits = np.unpackbits(coded, bitorder="little")
        code = bits[: 2 * n_bytes * 7].reshape(-1, 7)
        syn = (code @ _H.T) % 2
        sval = syn[:, 0] + 2 * syn[:, 1] + 4 * syn[:, 2]
        s2p = np.full(8, 7)
        for col in range(7):
            s = _H[:, col]
            s2p[int(s[0] + 2 * s[1] + 4 * s[2])] = col
        flip = (np.arange(7) == s2p[sval][:, None]).astype(np.uint8)
        corrected = (code + flip) % 2
        return np.packbits(corrected[:, :4].reshape(-1), bitorder="little")

    def test_encode_matches_reference(self):
        rng = np.random.default_rng(11)
        for n in [1, 2, 3, 4, 7, 64, 200, 333]:
            data = rng.integers(0, 256, n, dtype=np.uint8)
            got = np.asarray(hamming.encode(jnp.asarray(data)))
            np.testing.assert_array_equal(got, self._ref_encode(data), err_msg=f"n={n}")

    def test_decode_matches_reference_with_errors(self):
        rng = np.random.default_rng(12)
        for n in [1, 3, 64, 200]:
            data = rng.integers(0, 256, n, dtype=np.uint8)
            coded = self._ref_encode(data)
            # flip one random bit per codeword region in a few places
            bad = coded.copy()
            for pos in rng.integers(0, coded.shape[0], 5):
                bad[pos] ^= np.uint8(1) << rng.integers(0, 8)
            got = np.asarray(hamming.decode(jnp.asarray(bad), n))
            np.testing.assert_array_equal(got, self._ref_decode(bad, n), err_msg=f"n={n}")

    def test_batched_matches_flat(self):
        rng = np.random.default_rng(13)
        data = rng.integers(0, 256, (5, 96), dtype=np.uint8)
        enc = np.asarray(hamming.encode(jnp.asarray(data)))
        for i in range(5):
            np.testing.assert_array_equal(enc[i], self._ref_encode(data[i]))
        dec = np.asarray(hamming.decode(jnp.asarray(enc), 96))
        np.testing.assert_array_equal(dec, data)
