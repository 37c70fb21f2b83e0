"""The port's OCDBT reader against tensorstore's, on the CPU.

``odwscl_tpu_torch/utils/ocdbt.py:OcdbtStore`` must list the same keys and
read the same bytes as tensorstore's ``ocdbt`` driver (the library that
wrote them) on:
- an Orbax checkpoint written by the JAX package's ``Checkpointer.save``
  (two levels: the root store's leaves point into ``ocdbt.process_0/d/``;
  small values inline, the large ones as data references), read with the
  native and with the pure-Python zstd decoder;
- a store whose 200-byte node limit makes a B-tree five levels deep
  (interior nodes, their subtree key prefixes);
- a store with a ``numbered`` manifest (``manifest.<generation>``) and an
  8-byte inline limit.
Each file's magic, length, CRC-32C and compression method are checked: a
flipped byte, a truncated file or an unknown method raises ``ValueError``.
``crc32c`` equals ``google_crc32c``'s. No tolerance applies (bytes).
"""

import shutil

import google_crc32c
import numpy as np
import pytest
import tensorstore as ts

from odwscl_tpu_torch.utils import ocdbt, zstd


def _tensorstore(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    keys = sorted(kv.list().result())
    return {k: bytes(kv.read(k).result().value) for k in keys}


def _write_kv(root, config, n=60):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    for i in range(n):
        kv.write(f"key{i:03d}/{'x' * (i % 7)}", bytes([i]) * (i * 3)).result()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    from odwscl_tpu.utils.checkpoint import Checkpointer

    base = tmp_path_factory.mktemp("ocdbt")
    rng = np.random.RandomState(0)
    state = {"params": {"a": {"kernel": rng.randn(64, 32).astype(np.float32),
                              "bias": np.zeros(32, np.float32)}},
             "big": rng.randn(300, 200).astype(np.float32),
             "step": np.int32(7)}
    Checkpointer(str(base / "orbax")).save(7, state)
    _write_kv(str(base / "deep"), {"max_decoded_node_bytes": 200})
    _write_kv(str(base / "numbered"), {"manifest_kind": "numbered",
                                       "max_inline_value_bytes": 8})
    return {"orbax": str(base / "orbax" / "model_0000007"),
            "deep": str(base / "deep"), "numbered": str(base / "numbered")}


@pytest.mark.parametrize("name", ["orbax", "deep", "numbered"])
def test_keys_and_values_match_tensorstore(stores, name):
    want = _tensorstore(stores[name])
    store = ocdbt.OcdbtStore(stores[name])
    assert store.keys() == sorted(want)
    for k, v in want.items():
        assert store.get(k) == v, k
    if name == "orbax":
        inline = [k for k, v in store._index.items() if isinstance(v, bytes)]
        refs = [v[0] for v in store._index.values() if isinstance(v, tuple)]
        assert inline and refs
        assert all(r.startswith("ocdbt.process_0/d/") for r in refs)
    if name == "deep":
        assert store.height >= 2


def test_plain_decoder_reads_the_same(stores):
    root = stores["orbax"]
    native = ocdbt.OcdbtStore(root)
    plain = ocdbt.OcdbtStore(root, decompress=zstd.decompress_plain)
    assert plain.keys() == native.keys()
    for k in native.keys():
        assert plain.get(k) == native.get(k)


def _copy(stores, tmp_path, name="orbax"):
    dst = tmp_path / name
    shutil.copytree(stores[name], dst)
    return dst


def test_a_flipped_byte_fails_the_crc(stores, tmp_path):
    root = _copy(stores, tmp_path)
    path = root / "manifest.ocdbt"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtStore(str(root))


def test_bad_magic_length_and_method_raise(stores, tmp_path):
    raw = (_copy(stores, tmp_path) / "manifest.ocdbt").read_bytes()

    def fixed_crc(b):
        b = bytes(b[:-4])
        return b + ocdbt.crc32c(b).to_bytes(4, "little")

    with pytest.raises(ValueError, match="magic"):
        ocdbt.decode_file(raw, ocdbt.NODE_MAGIC, "m", zstd.decompress)
    with pytest.raises(ValueError, match="length"):
        ocdbt.decode_file(raw[:-1], ocdbt.MANIFEST_MAGIC, "m",
                          zstd.decompress)
    method = bytearray(raw)
    assert method[13] == 1                # version 0, method 1 (zstd)
    method[13] = 7
    with pytest.raises(ValueError, match="compression method 7"):
        ocdbt.decode_file(fixed_crc(method), ocdbt.MANIFEST_MAGIC, "m",
                          zstd.decompress)
    body = ocdbt.decode_file(raw, ocdbt.MANIFEST_MAGIC, "m", zstd.decompress)
    assert len(body) > 16


def test_a_missing_data_file_raises(stores, tmp_path):
    root = _copy(stores, tmp_path)
    store = ocdbt.OcdbtStore(str(root))
    shutil.rmtree(root / "ocdbt.process_0" / "d")
    ref = next(k for k, v in store._index.items() if isinstance(v, tuple))
    with pytest.raises(ValueError, match="missing OCDBT file"):
        store.get(ref)


def test_crc32c_matches_google_crc32c():
    rng = np.random.RandomState(3)
    for n in (0, 1, 7, 100, 4097):
        data = rng.bytes(n)
        assert ocdbt.crc32c(data) == google_crc32c.value(data)
