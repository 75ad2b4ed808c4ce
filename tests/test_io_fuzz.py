"""Property/fuzz tests for the from-scratch codecs (VERDICT r1 item 6).

The DICOM reader must parse the awkward-but-legal encodings real scanners
emit (implicit-VR sequences, defined- and undefined-length SQ, multi-value
DS, odd lengths) and must fail CLEANLY (ValueError/struct.error, never a
hang or a silent short-read) on corrupted bytes.  The TWIX reader must
handle multi-channel scans explicitly: kspace() refuses them with a
pointer to the multicoil API, and the RSS recon combines them correctly.
"""
import struct

import numpy as np
import pytest

from ventjax.io import dicom as dcm


def _implicit_element(tag, payload: bytes) -> bytes:
    return struct.pack("<HHI", tag[0], tag[1], len(payload)) + payload


def _implicit_sq_undefined(tag, items) -> bytes:
    out = struct.pack("<HHI", tag[0], tag[1], 0xFFFFFFFF)
    for item in items:
        out += struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF)
        out += item
        out += struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    return out


def _implicit_sq_defined(tag, items) -> bytes:
    body = b""
    for item in items:
        body += struct.pack("<HHI", 0xFFFE, 0xE000, len(item)) + item
    return struct.pack("<HHI", tag[0], tag[1], len(body)) + body


def test_implicit_vr_sequences_and_multivalue_ds(tmp_path):
    """A bare implicit-VR stream with nested PerFrameFunctionalGroups
    (both undefined- and defined-length forms) parses to the same voxel
    info the reference's header scan reads (Vent_Analysis.py:208-215)."""
    pm_item = _implicit_element((0x0028, 0x0030), b"1.5\\1.5 ")  # padded DS
    pm_seq_u = _implicit_sq_undefined((0x0028, 0x9110), [pm_item])
    pm_seq_d = _implicit_sq_defined((0x0028, 0x9110), [pm_item])
    for pm_seq in (pm_seq_u, pm_seq_d):
        frame_item = pm_seq
        stream = (
            _implicit_element((0x0008, 0x0020), b"20240301")
            + _implicit_element((0x0018, 0x0088), b"10.0")
            + _implicit_sq_undefined((0x5200, 0x9230), [frame_item])
        )
        p = tmp_path / "implicit.dcm"
        p.write_bytes(stream)
        ds = dcm.read_file(str(p))
        assert str(ds.StudyDate) == "20240301"
        assert float(ds.SpacingBetweenSlices) == 10.0
        seq = ds[(0x5200, 0x9230)]
        ps = seq[0]["PixelMeasuresSequence"][0].PixelSpacing
        assert [float(x) for x in ps] == [1.5, 1.5]


def test_odd_length_string_value(tmp_path):
    """Odd (spec-violating but common) value lengths parse byte-exactly."""
    stream = _implicit_element((0x0010, 0x0020), b"ABC")  # LO, length 3
    p = tmp_path / "odd.dcm"
    p.write_bytes(stream)
    ds = dcm.read_file(str(p))
    assert str(ds.PatientID) == "ABC"


def test_multivalue_is_and_ds_types(tmp_path):
    stream = (
        _implicit_element((0x0028, 0x0030), b"2.0\\2.0")
        + _implicit_element((0x0020, 0x0013), b"7")
    )
    p = tmp_path / "mv.dcm"
    p.write_bytes(stream)
    ds = dcm.read_file(str(p))
    assert [float(v) for v in ds.PixelSpacing] == [2.0, 2.0]
    assert int(ds.InstanceNumber) == 7


def test_truncated_and_mutated_files_fail_cleanly(tmp_path):
    """Truncations and random byte mutations either parse or raise — no
    hangs, no crashes, and a truncated PixelData is never silently
    accepted by pixel_array."""
    from ventjax.io.synthetic import write_multiframe

    vol = np.random.default_rng(0).normal(
        500, 100, (16, 16, 4)).astype(np.float64)
    path = tmp_path / "good.dcm"
    write_multiframe(str(path), vol, (1.5, 1.5, 10.0))
    good = path.read_bytes()

    # sanity: the pristine file parses
    ds = dcm.read_file(str(path))
    assert ds.pixel_array.shape[0] == 4

    rng = np.random.default_rng(123)
    bad = tmp_path / "bad.dcm"
    for trial in range(300):
        data = bytearray(good)
        mode = trial % 3
        if mode == 0:
            cut = int(rng.integers(1, len(data)))
            data = data[:cut]                      # truncation
        elif mode == 1:
            for _ in range(int(rng.integers(1, 8))):
                data[int(rng.integers(0, len(data)))] = int(
                    rng.integers(0, 256))          # byte flips
        else:                                      # splice a chunk in
            a, b = sorted(rng.integers(0, len(data), 2))
            pos = int(rng.integers(0, len(data)))
            data = data[:pos] + data[a:b] + data[pos:]
        bad.write_bytes(bytes(data))
        try:
            ds = dcm.read_file(str(bad))
            # parse may succeed (mutation hit a don't-care byte); touching
            # the pixels must still be safe.
            if "PixelData" in ds:
                try:
                    _ = ds.pixel_array
                except (ValueError, struct.error, KeyError, TypeError):
                    pass
        except (ValueError, struct.error, KeyError, EOFError, TypeError,
                MemoryError, OverflowError):
            pass  # clean rejection


def test_backslash_in_transfer_syntax_rejected_cleanly(tmp_path):
    """A corrupted TransferSyntaxUID with an embedded backslash parses as a
    MultiValue; read_file must raise ValueError, not crash on .startswith
    (found by the 4000-trial splice-fuzz campaign)."""
    from ventjax.io.synthetic import write_multiframe

    path = tmp_path / "ts.dcm"
    write_multiframe(str(path), np.full((8, 8, 2), 100.0), (1.5, 1.5, 10.0))
    data = path.read_bytes().replace(b"1.2.840.10008.1.2.1",
                                     b"1.2\\840.10008.1.2.1", 1)
    bad = tmp_path / "bad_ts.dcm"
    bad.write_bytes(data)
    with pytest.raises(ValueError, match="TransferSyntaxUID"):
        dcm.read_file(str(bad))


def test_twix_multichannel_rss():
    """Multi-coil twix: kspace() refuses (the reference is single-coil);
    kspace_multicoil + RSS recon equals the analytic root-sum-of-squares
    of per-coil recons."""
    import jax.numpy as jnp

    from ventjax.io.twix import read_twix, write_synthetic_twix
    from ventjax.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss,
    )

    rng = np.random.default_rng(5)
    k = (rng.normal(size=(3, 16, 12, 2))
         + 1j * rng.normal(size=(3, 16, 12, 2))).astype(np.complex64)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        dat = os.path.join(d, "mc.dat")
        write_synthetic_twix(dat, k)
        tw = read_twix(dat)
    assert tw.n_channels == 3
    with pytest.raises(ValueError, match="multicoil"):
        tw.kspace()
    kmc = tw.kspace_multicoil()
    np.testing.assert_allclose(kmc, k.astype(np.complex128), rtol=1e-6)
    rss = np.asarray(recon_2d_multislice_rss(jnp.asarray(kmc)))
    per_coil = np.stack([
        np.asarray(recon_2d_multislice(jnp.asarray(kmc[c])))
        for c in range(3)
    ])
    np.testing.assert_allclose(
        rss, np.sqrt((np.abs(per_coil) ** 2).sum(axis=0)), rtol=1e-5
    )


def test_twix_single_channel_unchanged():
    from ventjax.io.twix import read_twix, write_synthetic_twix

    rng = np.random.default_rng(6)
    k = (rng.normal(size=(16, 12, 2))
         + 1j * rng.normal(size=(16, 12, 2))).astype(np.complex64)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        dat = os.path.join(d, "sc.dat")
        write_synthetic_twix(dat, k)
        tw = read_twix(dat)
    assert tw.n_channels == 1
    np.testing.assert_allclose(tw.kspace(), k.astype(np.complex128),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Transfer syntaxes beyond plain LE (VERDICT r2 "missing" C2 family):
# pydicom 2.3.0 natively decodes Deflated Explicit VR LE and the retired
# Explicit VR Big Endian, so the reference app ingests them; the codec must
# too.  RLE Lossless has its own suite (test_io_rle.py).
# ---------------------------------------------------------------------------

def _meta_group(ts_uid: str) -> bytes:
    """Preamble + DICM + a minimal file-meta group (always explicit LE)."""
    uid = ts_uid.encode()
    if len(uid) % 2:
        uid += b"\x00"
    meta = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(uid)) + uid
    return b"\x00" * 128 + b"DICM" + meta


def _split_meta(buf: bytes) -> int:
    """Offset of the first non-group-0002 element in a Part-10 file."""
    pos = 132
    while True:
        group, _, vr, = struct.unpack_from("<HH2s", buf, pos)
        if group != 0x0002:
            return pos
        if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            pos += 12 + length
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            pos += 8 + length


def test_deflated_explicit_vr_le(tmp_path):
    """PS3.5 A.5: body after the meta group is one raw-deflate stream."""
    import zlib

    from ventjax.io.synthetic import write_multiframe

    vol = np.random.default_rng(7).normal(
        500, 100, (16, 16, 4)).astype(np.float64)
    plain = tmp_path / "plain.dcm"
    write_multiframe(str(plain), vol, (1.5, 1.5, 10.0))
    buf = plain.read_bytes()
    body = buf[_split_meta(buf):]

    co = zlib.compressobj(9, zlib.DEFLATED, -15)  # raw deflate, no header
    deflated = tmp_path / "deflated.dcm"
    deflated.write_bytes(
        _meta_group(dcm.DEFLATED_EXPLICIT_VR_LE)
        + co.compress(body) + co.flush())

    ref = dcm.read_file(str(plain))
    ds = dcm.read_file(str(deflated))
    assert str(ds.PatientName) == str(ref.PatientName)
    assert float(ds.SpacingBetweenSlices) == 10.0
    np.testing.assert_array_equal(ds.pixel_array, ref.pixel_array)


def _be_element(tag, vr: str, payload: bytes) -> bytes:
    out = struct.pack(">HH", tag[0], tag[1]) + vr.encode()
    if vr in ("OB", "OW", "OF", "SQ", "UN", "UT"):
        return out + b"\x00\x00" + struct.pack(">I", len(payload)) + payload
    return out + struct.pack(">H", len(payload)) + payload


def test_explicit_vr_big_endian(tmp_path):
    """Retired Explicit VR Big Endian: every binary field byte-swapped."""
    rng = np.random.default_rng(11)
    pix = rng.integers(0, 4000, (16, 12), dtype=np.uint16)
    body = b"".join([
        _be_element((0x0010, 0x0010), "PN", b"BIG^ENDIAN"),
        _be_element((0x0028, 0x0010), "US", struct.pack(">H", 16)),
        _be_element((0x0028, 0x0011), "US", struct.pack(">H", 12)),
        _be_element((0x0028, 0x0030), "DS", b"1.5\\1.5 "),
        _be_element((0x0028, 0x0100), "US", struct.pack(">H", 16)),
        _be_element((0x0028, 0x0103), "US", struct.pack(">H", 0)),
        _be_element((0x7FE0, 0x0010), "OW",
                    pix.astype(">u2").tobytes()),
    ])
    path = tmp_path / "be.dcm"
    path.write_bytes(_meta_group(dcm.EXPLICIT_VR_BE) + body)

    ds = dcm.read_file(str(path))
    assert int(ds.Rows) == 16 and int(ds.Columns) == 12
    assert list(ds.PixelSpacing) == [1.5, 1.5]
    arr = ds.pixel_array
    assert arr.dtype == np.uint16 and arr.dtype.byteorder in ("=", "|", "<")
    np.testing.assert_array_equal(arr, pix)

    # re-save transcodes to native Explicit LE (no stale TransferSyntaxUID)
    out = tmp_path / "resaved.dcm"
    ds.save_as(str(out))
    ds2 = dcm.read_file(str(out))
    assert ds2.get("TransferSyntaxUID") == dcm.EXPLICIT_VR_LE
    np.testing.assert_array_equal(ds2.pixel_array, pix)


def test_deflated_native_scanner_parity(tmp_path):
    """The native scanner inflates Deflated Explicit VR LE bodies
    (dicomscan.cpp inflate_raw) and byte-swaps retired Explicit VR Big
    Endian files (swap_pixels_be); both must match the Python codec."""
    import zlib

    from ventjax.io import native
    from ventjax.io.synthetic import write_multiframe

    if not native.available():
        pytest.skip("native scanner unavailable")

    vol = np.random.default_rng(3).normal(
        500, 100, (16, 16, 4)).astype(np.float64)
    plain = tmp_path / "plain.dcm"
    write_multiframe(str(plain), vol, (1.5, 1.5, 10.0))
    buf = plain.read_bytes()
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    deflated = tmp_path / "deflated.dcm"
    deflated.write_bytes(_meta_group(dcm.DEFLATED_EXPLICIT_VR_LE)
                         + co.compress(buf[_split_meta(buf):]) + co.flush())

    got = native.decode_pixels(str(deflated))
    assert got is not None
    np.testing.assert_array_equal(got[0], dcm.read_file(str(deflated)).pixel_array)
    assert got[1][:2] == (1.5, 1.5)

    # truncated deflate stream: clean rejection, not a crash
    blob = deflated.read_bytes()
    cut = tmp_path / "cut.dcm"
    cut.write_bytes(blob[:len(blob) - 40])
    assert native.decode_pixels(str(cut)) is None

    pix = np.random.default_rng(5).integers(0, 4000, (16, 12), dtype=np.uint16)
    body = b"".join([
        _be_element((0x0028, 0x0010), "US", struct.pack(">H", 16)),
        _be_element((0x0028, 0x0011), "US", struct.pack(">H", 12)),
        _be_element((0x0028, 0x0100), "US", struct.pack(">H", 16)),
        _be_element((0x0028, 0x0103), "US", struct.pack(">H", 0)),
        _be_element((0x7FE0, 0x0010), "OW", pix.astype(">u2").tobytes()),
    ])
    be = tmp_path / "be.dcm"
    be.write_bytes(_meta_group(dcm.EXPLICIT_VR_BE) + body)
    got_be = native.decode_pixels(str(be))
    assert got_be is not None
    np.testing.assert_array_equal(got_be[0], pix)
    np.testing.assert_array_equal(dcm.read_file(str(be)).pixel_array, pix)


def test_native_differential_fuzz(tmp_path):
    """Differential fuzz of the native scanner against the Python codec.

    The native fast path's safety contract (ventjax/io/native.py): it may
    return None on anything unusual (Python codec takes over), but it must
    NEVER crash the process and NEVER return pixels that differ from a
    successful Python decode of the same bytes.  Seeds are fixed so the
    corpus is reproducible.
    """
    import zlib

    from ventjax.io import native
    from ventjax.io.synthetic import write_multiframe
    from test_io_rle import write_rle_file

    if not native.available():
        pytest.skip("native scanner unavailable")

    rng = np.random.default_rng(2024)
    vol = rng.normal(500, 100, (12, 12, 3)).astype(np.float64)

    # one valid file per supported transfer syntax
    plain = tmp_path / "plain.dcm"
    write_multiframe(str(plain), vol, (1.5, 1.5, 10.0))
    buf = plain.read_bytes()
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    (tmp_path / "deflated.dcm").write_bytes(
        _meta_group(dcm.DEFLATED_EXPLICIT_VR_LE)
        + co.compress(buf[_split_meta(buf):]) + co.flush())
    write_rle_file(str(tmp_path / "rle.dcm"),
                   rng.integers(0, 65536, (3, 12, 12)).astype(np.uint16))
    bepix = rng.integers(0, 65536, (12, 12), dtype=np.uint16)
    be_body = b"".join([
        _be_element((0x0028, 0x0010), "US", struct.pack(">H", 12)),
        _be_element((0x0028, 0x0011), "US", struct.pack(">H", 12)),
        _be_element((0x0028, 0x0100), "US", struct.pack(">H", 16)),
        _be_element((0x0028, 0x0103), "US", struct.pack(">H", 0)),
        _be_element((0x7FE0, 0x0010), "OW", bepix.astype(">u2").tobytes()),
    ])
    (tmp_path / "be.dcm").write_bytes(
        _meta_group(dcm.EXPLICIT_VR_BE) + be_body)

    corpus = [plain.read_bytes(),
              (tmp_path / "deflated.dcm").read_bytes(),
              (tmp_path / "rle.dcm").read_bytes(),
              (tmp_path / "be.dcm").read_bytes()]

    def python_decode(path):
        try:
            ds = dcm.read_file(path)
            return np.asarray(ds.pixel_array)
        except Exception:
            return None

    n_flip, n_trunc, n_agree = 0, 0, 0
    mut = tmp_path / "mut.dcm"
    for blob in corpus:
        for trial in range(120):
            b = bytearray(blob)
            kind = rng.integers(0, 3)
            if kind == 0:      # random byte flips (1-8)
                for _ in range(int(rng.integers(1, 9))):
                    b[int(rng.integers(0, len(b)))] = int(rng.integers(256))
                n_flip += 1
            elif kind == 1:    # truncation
                b = b[:int(rng.integers(1, len(b)))]
                n_trunc += 1
            else:              # splice a random chunk
                at = int(rng.integers(0, len(b)))
                b[at:at] = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                                              dtype=np.uint8))
            mut.write_bytes(bytes(b))
            got = native.decode_pixels(str(mut))   # must never raise
            if got is None:
                continue
            py = python_decode(str(mut))
            if py is None:
                # native salvaged a file Python refuses: acceptable only if
                # the mutation left the pixel grid intact vs the original.
                continue
            if got[0].shape == py.shape:
                np.testing.assert_array_equal(got[0], py)
                n_agree += 1
    # the corpus must actually exercise both mutation classes and produce
    # a healthy number of agreeing decodes (byte flips in pixel data still
    # decode on both sides)
    assert n_flip > 50 and n_trunc > 50 and n_agree > 20, (
        n_flip, n_trunc, n_agree)


def _meta_group_with_length(ts_uid: str) -> bytes:
    """Preamble + DICM + meta group led by the mandatory (0002,0000)
    FileMetaInformationGroupLength element."""
    uid = ts_uid.encode()
    if len(uid) % 2:
        uid += b"\x00"
    ts_el = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(uid)) + uid
    gl_el = struct.pack("<HH2sH", 0x0002, 0x0000, b"UL", 4) + struct.pack(
        "<I", len(ts_el))
    return b"\x00" * 128 + b"DICM" + gl_el + ts_el


def test_meta_group_length_bounds_deflated_body(tmp_path):
    """PS3.10: (0002,0000) bounds the meta group.  A raw-deflate body whose
    first bytes are 02 00 parses as a group-0002 tag, so a reader that
    finds the meta end by tag-peeking eats compressed bytes and rejects a
    standards-valid file.  Both codecs must honor the group length.

    The crafted stream opens with an empty non-final fixed-huffman block
    (bits 0,1,0 + seven-zero-bit end-of-block = bytes 02 00 after an empty
    stored block header) before a final stored block with the real data."""
    from ventjax.io import native
    from ventjax.io.synthetic import write_multiframe

    import zlib

    vol = np.random.default_rng(9).normal(
        500, 100, (16, 16, 4)).astype(np.float64)
    plain = tmp_path / "plain.dcm"
    write_multiframe(str(plain), vol, (1.5, 1.5, 10.0))
    buf = plain.read_bytes()
    body = buf[_split_meta(buf):]
    assert len(body) < 65536, "stored deflate block limit"
    # non-final fixed-huffman empty block (02 00 prefix by construction),
    # then an empty non-final stored block, then the final stored block
    stream = (b"\x02\x00" + b"\x00\x00\xff\xff"
              + b"\x01" + struct.pack("<HH", len(body), ~len(body) & 0xFFFF)
              + body)
    assert zlib.decompress(stream, -15) == body
    assert stream[:2] == b"\x02\x00"   # the tag-peek trap
    p = tmp_path / "trap.dcm"
    p.write_bytes(_meta_group_with_length(dcm.DEFLATED_EXPLICIT_VR_LE)
                  + stream)

    ds = dcm.read_file(str(p))
    np.testing.assert_array_equal(
        np.transpose(ds.pixel_array, (1, 2, 0)),
        dcm.read_file(str(plain)).pixel_array.transpose(1, 2, 0))
    if native.available():
        got = native.decode_pixels(str(p))
        assert got is not None
        np.testing.assert_array_equal(got[0], ds.pixel_array)


def test_native_meta_scan_truncated_uid_length(tmp_path):
    """A (0002,0010) element whose declared length runs past the end of the
    file must make the native scanner return None (rc!=0), never read out
    of bounds; the Python codec raises cleanly."""
    from ventjax.io import native

    blob = (b"\x00" * 128 + b"DICM"
            + struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", 0xFFF0)
            + b"1.2.8")
    p = tmp_path / "oob.dcm"
    p.write_bytes(blob)
    if native.available():
        assert native.decode_pixels(str(p)) is None
    with pytest.raises(Exception):
        dcm.read_file(str(p))


def test_rle_16_segment_header_rejected():
    """samples=4 x 32 bits = 16 segments passes nseg==samples*bpp but can
    never fit the 15-offset header; must fail with the documented
    ValueError, not an IndexError."""
    frag = struct.pack("<16I", 16, *([64] * 15)) + b"\x00" * 100
    with pytest.raises(ValueError, match="segments"):
        dcm._rle_decode_frame(frag, 4, 4, 4, 32)


def test_twix_service_scans_filtered_like_mapvbvd(tmp_path):
    """Real scanner files interleave SYNCDATA physio packets and
    noise-adjust/phasecor scans with the image lines; mapvbvd returns only
    the image set (the reference consumes exactly that), so read_twix must
    skip SYNCDATA by DMA length and filter non-image scans whose loop
    counters collide with image line 0."""
    import os
    from ventjax.io.twix import read_twix, write_synthetic_twix

    rng = np.random.default_rng(21)
    k = (rng.normal(size=(12, 10, 3))
         + 1j * rng.normal(size=(12, 10, 3))).astype(np.complex64)
    clean, noisy = str(tmp_path / "c.dat"), str(tmp_path / "n.dat")
    write_synthetic_twix(clean, k)
    write_synthetic_twix(noisy, k, service_scans=True)
    assert os.path.getsize(noisy) > os.path.getsize(clean)
    np.testing.assert_array_equal(read_twix(noisy).kspace(),
                                  read_twix(clean).kspace())


def test_twix_vb_service_scans_filtered(tmp_path):
    """The VB reader must skip SYNCDATA physio blocks and filter
    noise-adjust/phasecor scans the same way the VD/VE reader does."""
    from ventjax.io.twix import read_twix, write_synthetic_twix_vb

    rng = np.random.default_rng(24)
    k = (rng.normal(size=(10, 8, 2))
         + 1j * rng.normal(size=(10, 8, 2))).astype(np.complex64)
    clean, noisy = str(tmp_path / "c.dat"), str(tmp_path / "n.dat")
    write_synthetic_twix_vb(clean, k)
    write_synthetic_twix_vb(noisy, k, service_scans=True)
    np.testing.assert_array_equal(read_twix(noisy).kspace(),
                                  read_twix(clean).kspace())


def test_twix_vb_malformed_syncdata_rejected(tmp_path):
    """A VB SYNCDATA MDH whose DMA length overruns the file must raise,
    not desync the parse into sample bytes."""
    import struct as _struct
    from ventjax.io import twix as tw

    rng = np.random.default_rng(25)
    k = (rng.normal(size=(8, 6, 2))
         + 1j * rng.normal(size=(8, 6, 2))).astype(np.complex64)
    p = str(tmp_path / "bad.dat")
    tw.write_synthetic_twix_vb(p, k, service_scans=True)
    buf = bytearray(open(p, "rb").read())
    found = False
    for off in range(0, len(buf) - tw._MDH_VB_SIZE):
        (mask,) = _struct.unpack_from("<I", buf, off + 20)
        if mask == tw.SYNCDATA:
            (dma,) = _struct.unpack_from("<I", buf, off)
            if dma == tw._MDH_VB_SIZE + 60:  # the writer's packet
                _struct.pack_into("<I", buf, off, len(buf) + 1)
                found = True
                break
    assert found, "VB SYNCDATA MDH not located"
    open(p, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match="SYNCDATA"):
        tw.read_twix(p)


def test_twix_malformed_syncdata_rejected(tmp_path):
    """A SYNCDATA MDH with a zero/overflowing DMA length cannot be skipped
    safely; the reader must raise, never desync into sample bytes."""
    import struct as _struct
    from ventjax.io import twix as tw

    rng = np.random.default_rng(22)
    k = (rng.normal(size=(8, 6, 2))
         + 1j * rng.normal(size=(8, 6, 2))).astype(np.complex64)
    p = str(tmp_path / "bad.dat")
    tw.write_synthetic_twix(p, k, service_scans=True)
    buf = bytearray(open(p, "rb").read())
    # find the SYNCDATA MDH (eval mask u64 at offset 40 in the 192-byte MDH)
    found = False
    for off in range(0, len(buf) - tw._MDH_SIZE):  # MDHs are not aligned
        (mask,) = _struct.unpack_from("<Q", buf, off + 40)
        if mask == tw.SYNCDATA:
            (dma,) = _struct.unpack_from("<I", buf, off)
            if dma == tw._MDH_SIZE + 100:  # the writer's packet
                _struct.pack_into("<I", buf, off, 0)  # zero the DMA length
                found = True
                break
    assert found, "SYNCDATA MDH not located"
    open(p, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match="SYNCDATA"):
        tw.read_twix(p)


def test_twix_64_measurement_multiraid_detected(tmp_path):
    """mapvbvd's layout heuristic accepts up to 64 raid entries; an
    exactly-64-measurement file must be parsed as multi-raid (last
    measurement wins), not misrouted to the VB reader."""
    import struct as _struct
    from ventjax.io.twix import read_twix, write_synthetic_twix

    rng = np.random.default_rng(23)
    k = (rng.normal(size=(8, 6, 2))
         + 1j * rng.normal(size=(8, 6, 2))).astype(np.complex64)
    p1 = str(tmp_path / "one.dat")
    write_synthetic_twix(p1, k)
    buf = open(p1, "rb").read()
    meas_id, file_id, meas_off, meas_len = _struct.unpack_from("<IIQQ",
                                                               buf, 8)
    body = buf[meas_off:meas_off + meas_len]
    entry = bytearray(buf[8:160])

    n = 64
    hdr_size = 8 + n * 152
    pad = (-hdr_size) % 512
    new_off = hdr_size + pad
    _struct.pack_into("<IIQQ", entry, 0, meas_id, file_id, new_off,
                      meas_len)
    out = _struct.pack("<II", 0, n)
    out += bytes(152) * (n - 1) + bytes(entry)
    out += b"\x00" * pad + body
    p64 = str(tmp_path / "sixtyfour.dat")
    open(p64, "wb").write(out)
    np.testing.assert_array_equal(read_twix(p64).kspace(),
                                  read_twix(p1).kspace())


def test_recon_matmul_dft_matches_fft_oracle():
    """The recon is a centered DFT expressed as real matmuls on split
    real/imag planes.  Pin it against the np.fft recipe the reference
    runs (Vent_Analysis.py:537-540) at non-square and non-power-of-two
    sizes, where a wrong shift permutation or transposed DFT matrix
    cannot hide."""
    from ventjax.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss,
    )

    rng = np.random.default_rng(11)
    # the final size reuses dimensions from EARLIER traces: the DFT-matrix
    # cache must hand back host constants, not a prior trace's tracers
    for (h, w, s) in [(16, 12, 2), (64, 64, 3), (128, 100, 2), (13, 9, 2),
                      (128, 64, 2)]:
        k = (rng.normal(size=(h, w, s))
             + 1j * rng.normal(size=(h, w, s))).astype(np.complex64)
        img = recon_2d_multislice(k)
        want = np.transpose(
            np.fft.fftshift(np.fft.fft2(np.fft.fftshift(
                k.astype(np.complex128), axes=(0, 1)), axes=(0, 1)),
                axes=(0, 1)),
            (1, 0, 2))[:, ::-1, :]
        assert np.abs(img - want).max() / np.abs(want).max() < 1e-5
    kmc = (rng.normal(size=(3, 16, 12, 2))
           + 1j * rng.normal(size=(3, 16, 12, 2))).astype(np.complex64)
    per = np.stack([np.asarray(recon_2d_multislice(kmc[c]))
                    for c in range(3)])
    np.testing.assert_allclose(
        recon_2d_multislice_rss(kmc),
        np.sqrt((np.abs(per) ** 2).sum(axis=0)), rtol=1e-5)


def test_twix_zero_payload_syncdata_skipped(tmp_path):
    """A SYNCDATA MDH whose DMA length equals the MDH size carries no
    payload; the skip lands exactly at the next MDH and the file must
    parse (only DMA < MDH size or overrun is malformed)."""
    import struct as _struct
    from ventjax.io import twix as tw

    rng = np.random.default_rng(26)
    k = (rng.normal(size=(8, 6, 2))
         + 1j * rng.normal(size=(8, 6, 2))).astype(np.complex64)
    clean, noisy = str(tmp_path / "c.dat"), str(tmp_path / "n.dat")
    tw.write_synthetic_twix(clean, k)
    tw.write_synthetic_twix(noisy, k, service_scans=True)
    buf = bytearray(open(noisy, "rb").read())
    for off in range(0, len(buf) - tw._MDH_SIZE):
        (mask,) = _struct.unpack_from("<Q", buf, off + 40)
        if mask == tw.SYNCDATA:
            (dma,) = _struct.unpack_from("<I", buf, off)
            if dma == tw._MDH_SIZE + 100:
                # rewrite as zero-payload: DMA == MDH size, drop payload
                _struct.pack_into("<I", buf, off, tw._MDH_SIZE)
                del buf[off + tw._MDH_SIZE:off + tw._MDH_SIZE + 100]
                break
    else:
        raise AssertionError("SYNCDATA MDH not located")
    open(noisy, "wb").write(bytes(buf))
    np.testing.assert_array_equal(tw.read_twix(noisy).kspace(),
                                  tw.read_twix(clean).kspace())
