"""RIMFS durability in the port on the CPU, held against the JAX package:
journaled installs through a fault at every mid-write point
(tests/test_integrity.py:183-246), the same journal records and image bytes
as the JAX ``ImageStore`` for the same fault matrix, a crash of either
package's ``install`` recovered by the other's ``fsck`` from the files on
disk, ``save_file``/``mount_file`` bytes, and the image accessors."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import rimfs as jax_rimfs
from repro.core.integrity import IntegrityError as JaxIntegrityError
from repro_torch.core import rhal, rimfs
from repro_torch.core.integrity import IntegrityError

PHASES = (("after_intent", "a"), ("after_stage", "a"), ("after_commit", "b"))


def _images(rng):
    a = {"w": rng.randn(8).astype(np.float32)}
    b = {"w": rng.randn(8).astype(np.float32)}
    return rimfs.pack(a), rimfs.pack(b)


def test_journaled_install_fault_matrix(rng):
    """A fault at every mid-write point leaves the visible image wholly old
    or wholly new; fsck rolls back uncommitted staging and replays
    committed flips."""
    img_a, img_b = _images(rng)
    store = rimfs.ImageStore(img_a)
    assert store.image() == img_a
    for phase, visible in PHASES:
        with pytest.raises(IntegrityError, match="injected"):
            store.install(img_b, fail_at=phase)
        assert store.image() in (img_a, img_b)   # never a mixture
        rep = store.fsck(strict=True)
        assert store.image() == (img_a if visible == "a" else img_b)
        assert rep["image"]["ok"]
        if phase == "after_commit":
            assert len(rep["replayed"]) == 1
        else:
            assert len(rep["rolled_back"]) == 1
        store._image = bytes(img_a)              # reset for next phase
    assert not store.journal.pending()


def test_journaled_install_survives_process_crash(tmp_path, rng):
    """File-backed durability: the 'crash' is a NEW ImageStore over the same
    path; recovery comes from the journal and stage files on disk only."""
    img_a, img_b = _images(rng)
    path = tmp_path / "store.rimfs"
    store = rimfs.ImageStore(img_a, path=path)
    with pytest.raises(IntegrityError):          # crash after commit mark
        store.install(img_b, fail_at="after_commit")
    survivor = rimfs.ImageStore(path=path)
    assert survivor.image() == img_a             # flip never landed
    rep = survivor.fsck(strict=True)
    assert len(rep["replayed"]) == 1
    assert survivor.image() == img_b             # redo from staged bytes
    assert path.read_bytes() == img_b
    with pytest.raises(IntegrityError):          # crash before commit
        survivor.install(img_a, fail_at="after_stage")
    survivor2 = rimfs.ImageStore(path=path)
    rep = survivor2.fsck(strict=True)
    assert len(rep["rolled_back"]) == 1          # undo: stays on img_b
    assert survivor2.image() == img_b
    assert not survivor2.journal.pending()


def test_image_store_plain_install_roundtrip(rng):
    img = rimfs.pack({"w": rng.randn(4).astype(np.float32)})
    store = rimfs.ImageStore()
    with pytest.raises(rimfs.RIMFSError, match="empty"):
        store.mount()
    store.install(img)
    fs = store.mount()
    assert fs.files() == ["w"]
    assert store.fsck(strict=True)["image"]["ok"]


def _run_matrix(mod, err, img_a, img_b, path=None):
    """The fault matrix through one package's store; returns the journal
    records, each fsck report and the visible image after each phase."""
    store = mod.ImageStore(img_a, path=path)
    reports, visible = [], []
    for phase, _ in PHASES:
        with pytest.raises(err):
            store.install(img_b, fail_at=phase)
        rep = store.fsck(strict=True)
        reports.append({k: rep[k] for k in ("replayed", "rolled_back")})
        visible.append(store.image())
    return store.journal.records(), reports, visible


@pytest.mark.parametrize("on_disk", [False, True])
def test_fault_matrix_records_and_bytes_equal_jax(tmp_path, rng, on_disk):
    img_a, img_b = _images(rng)
    paths = (tmp_path / "port.rimfs", tmp_path / "jax.rimfs") if on_disk \
        else (None, None)
    port = _run_matrix(rimfs, IntegrityError, img_a, img_b, paths[0])
    ref = _run_matrix(jax_rimfs, JaxIntegrityError, img_a, img_b, paths[1])
    assert port == ref
    assert port[2] == [img_a, img_a, img_b]
    if on_disk:          # the journal files hold the same lines, byte for byte
        jp, jj = (pathlib.Path(f"{p}.journal").read_bytes() for p in paths)
        assert jp == jj
        assert paths[0].read_bytes() == paths[1].read_bytes() == img_b
        # one JSON object a line, compact separators
        for line in jp.decode().splitlines():
            assert json.dumps(json.loads(line), separators=(",", ":")) == line


@pytest.mark.parametrize("phase,visible", PHASES)
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_crash_recovered_by_the_other_package(tmp_path, rng, phase, visible,
                                              writer, reader):
    """One package's install crashes at ``phase``; the other package's
    ``ImageStore`` over the same path recovers from the journal and the
    ``.stage<txid>`` files alone."""
    img_a, img_b = _images(rng)
    mods = {"jax": (jax_rimfs, JaxIntegrityError),
            "port": (rimfs, IntegrityError)}
    path = tmp_path / "store.rimfs"
    wmod, werr = mods[writer]
    store = wmod.ImageStore(img_a, path=path)
    with pytest.raises(werr):
        store.install(img_b, fail_at=phase)
    staged = sorted(p.name for p in tmp_path.iterdir() if ".stage" in p.name)
    assert staged == ([] if phase == "after_intent" else ["store.rimfs.stage2"])
    rmod, _ = mods[reader]
    survivor = rmod.ImageStore(path=path)
    rep = survivor.fsck(strict=True)
    want = img_a if visible == "a" else img_b
    assert survivor.image() == want and path.read_bytes() == want
    assert (rep["replayed"], rep["rolled_back"]) == \
        (([2], []) if visible == "b" else ([], [2]))
    assert not survivor.journal.pending()
    assert not any(".stage" in p.name for p in tmp_path.iterdir())
    # the writer's package reads the resolved journal the same way
    again = wmod.ImageStore(path=path)
    assert again.journal.records() == survivor.journal.records()
    assert not again.journal.pending() and again.image() == want


def test_save_file_and_mount_file_equal_jax(tmp_path, rng):
    files = {"a": rng.randn(3, 5).astype(np.float32),
             "b": rng.randint(-9, 9, (7,)).astype(np.int32)}
    pp, jp = tmp_path / "port.rimfs", tmp_path / "jax.rimfs"
    assert rimfs.save_file(pp, files) == jax_rimfs.save_file(jp, files)
    assert pp.read_bytes() == jp.read_bytes() == rimfs.pack(files)
    fs, jfs = rimfs.mount_file(jp), jax_rimfs.mount_file(pp)
    assert isinstance(fs._data, np.memmap)
    assert fs.verify_image() and fs.fsck(strict=True)["ok"]
    for name in files:
        np.testing.assert_array_equal(fs.read(name).numpy(), files[name])
        np.testing.assert_array_equal(fs.read(name).numpy(),
                                      np.asarray(jfs.read(name)))
        assert fs.address_of(name) == jfs.address_of(name)
    assert fs.total_bytes() == jfs.total_bytes() == len(pp.read_bytes())
    assert fs.overhead_bytes() == jfs.overhead_bytes()


def test_image_accessors_and_pinned_offsets(rng):
    files = {f"w{i}": rng.randn(16, 16).astype(np.float32)
             for i in range(3)}
    files["h"] = torch.from_numpy(rng.randn(5).astype(np.float32)).to(
        torch.bfloat16)
    img = rimfs.pack(files)
    fs, jfs = rimfs.mount(img), jax_rimfs.mount(img)
    for name in files:
        assert fs.address_of(name) == jfs.address_of(name)
    assert fs.total_bytes() == jfs.total_bytes() == len(img)
    assert fs.overhead_bytes() == jfs.overhead_bytes()
    drv = rhal.make_eager_driver("cpu")
    ri = fs.resident(drv)
    offsets = sorted(ri.offset_of(n) for n in files)
    assert offsets == [o for o, _ in ri.pinned_ranges()]
    assert ri.offset_of("missing") is None
    ri.unpin()
    assert fs._resident == {}
