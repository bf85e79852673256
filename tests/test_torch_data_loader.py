"""The port's native data pipeline (``normflows_tpu_torch.data``) against the
JAX package's (``normflows_tpu.data``) on the same uint8 images and seeds.

* The port builds its own copy of ``csrc/nf_dataloader.cpp`` (the same
  producer): its native batches equal the JAX package's native batches bit
  for bit, shuffle and jitter included, and so do the two plain numpy
  producers (``force_numpy=True``).
* With shuffle and jitter off, the transform equals ``utils.preprocessing``'s
  ``Scale`` then ``Logit`` of both packages (rtol = atol = 1e-6, the JAX
  package's own bar in tests/test_data_loader.py).
* Each epoch is a permutation of the dataset; batches do not depend on the
  worker count; a source that does not compile raises with the compiler's
  output (no silent numpy fallback).
* ``prefetch_to_device`` on the CPU passes batches through; its ``mesh``
  form (each rank's rows) runs in the world of tests/test_torch_parallel.py,
  its card form (pinned memory, a copy stream) in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu import data as jdata
from normflows_tpu.utils import preprocessing as jpre
from normflows_tpu_torch import data
from normflows_tpu_torch.data import native_loader
from normflows_tpu_torch.utils import preprocessing

torch.set_num_threads(2)

TOL = 1e-6


def make_dataset(n=64, shape=(3, 4, 4), seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(n,), dtype=np.int64)
    return images, labels


def batches(loader, k):
    out = [next(loader) for _ in range(k)]
    loader.close()
    return out


@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
def test_batches_equal_the_jax_package(force_numpy):
    """Shuffled, jittered, logit batches over three epochs: the same bits."""
    images, labels = make_dataset(n=40)
    kw = dict(batch_size=8, shuffle=True, jitter=True, logit=True, seed=5, num_workers=3,
              force_numpy=force_numpy)
    mine = batches(data.NativeImageLoader(images, labels, **kw), 15)
    theirs = batches(jdata.NativeImageLoader(images, labels, **kw), 15)
    for (x, y, e), (jx, jy, je) in zip(mine, theirs):
        assert x.dtype == torch.float32 and y.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y.numpy(), jy)
        assert e == je
    assert [e for _, _, e in mine] == [0] * 5 + [1] * 5 + [2] * 5


@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
def test_deterministic_transform_matches_preprocessing(force_numpy):
    images, labels = make_dataset(n=32)
    loader = data.NativeImageLoader(images, labels, batch_size=8, shuffle=False,
                                    jitter=False, alpha=0.05, num_workers=2,
                                    force_numpy=force_numpy)
    assert loader.is_native == (not force_numpy)
    (x, y, epoch), = batches(loader, 1)
    assert epoch == 0 and tuple(x.shape) == (8, 3, 4, 4)
    np.testing.assert_array_equal(y.numpy(), labels[:8])
    scaled = np.asarray(images[:8], np.float64) / 255.0
    want = preprocessing.Logit(alpha=0.05)(preprocessing.Scale()(torch.from_numpy(scaled)))
    np.testing.assert_allclose(x.numpy(), want.float().numpy(), rtol=TOL, atol=TOL)
    jwant = jpre.Logit(alpha=0.05)(jnp.asarray(scaled * (255.0 / 256.0)))
    np.testing.assert_allclose(x.numpy(), np.asarray(jwant, np.float32), rtol=TOL, atol=TOL)


def test_each_epoch_is_a_permutation():
    images, labels = make_dataset(n=24, shape=(2,))
    loader = data.NativeImageLoader(images, np.arange(24), batch_size=8, shuffle=True,
                                    jitter=False, logit=False, scale=1.0, seed=3,
                                    num_workers=2)
    assert loader.batches_per_epoch == 3
    epochs = {}
    for x, y, e in batches(loader, 6):
        epochs.setdefault(e, []).append(y.numpy())
        # the rows are the images of the labels they carry
        np.testing.assert_array_equal(x.numpy(), (images[y.numpy()] / 255.0).astype(np.float32))
    order = {e: np.concatenate(v) for e, v in epochs.items()}
    for e in (0, 1):
        np.testing.assert_array_equal(np.sort(order[e]), np.arange(24))
    assert not np.array_equal(order[0], order[1])


def test_batches_do_not_depend_on_the_workers():
    images, _ = make_dataset(n=32)

    def collect(workers):
        return batches(data.NativeImageLoader(images, None, batch_size=8, jitter=True,
                                              logit=False, seed=7, num_workers=workers), 8)

    one, four = collect(1), collect(4)
    for (a, ya, ea), (b, yb, eb) in zip(one, four):
        assert torch.equal(a, b) and ya is None and yb is None and ea == eb
    assert all(0.0 <= float(x.min()) and float(x.max()) <= 1.0 for x, _, _ in one)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "nf_dataloader.cpp"
    broken.write_text(native_loader.SOURCE.read_text().replace("extern \"C\" {",
                                                               "extern \"C\" { not c++"))
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
    images, _ = make_dataset(n=16)
    with pytest.raises(RuntimeError, match="building the native data loader failed"):
        data.NativeImageLoader(images, batch_size=4)
    assert not data.native_available()
    assert not list((tmp_path / "_build").glob("*"))  # no torn library left behind
    # the plain producer runs only when asked, and needs no build
    x, _, _ = next(data.NativeImageLoader(images, batch_size=4, force_numpy=True))
    assert tuple(x.shape) == (4, 3, 4, 4)


def test_prefetch_to_device_on_the_cpu():
    images, labels = make_dataset(n=32)
    loader = data.NativeImageLoader(images, labels, batch_size=8, shuffle=False,
                                    jitter=False, num_workers=2)
    want = batches(data.NativeImageLoader(images, labels, batch_size=8, shuffle=False,
                                          jitter=False, num_workers=2), 5)
    stream = data.prefetch_to_device(loader, size=2, device="cpu")
    for x, y, e in want:
        gx, gy, ge = next(stream)
        assert gx.device.type == "cpu" and torch.equal(gx, x) and torch.equal(gy, y)
        assert ge == e
    loader.close()
    # a finite iterator drains, labels or not
    plain = [(torch.full((2, 3), float(i)), None, 0) for i in range(3)]
    got = list(data.prefetch_to_device(iter(plain), size=2, device="cpu"))
    assert [float(x[0, 0]) for x, _, _ in got] == [0.0, 1.0, 2.0]
    assert all(y is None for _, y, _ in got)


def test_rejects_what_it_cannot_load():
    images, labels = make_dataset(n=16)
    with pytest.raises(TypeError, match="uint8"):
        data.NativeImageLoader(images.astype(np.float32), batch_size=4)
    with pytest.raises(ValueError, match="length mismatch"):
        data.NativeImageLoader(images, labels[:8], batch_size=4)
    with pytest.raises(ValueError, match="smaller than one batch"):
        data.NativeImageLoader(images, batch_size=32)
    with pytest.raises(ValueError, match="size"):
        next(data.prefetch_to_device(iter([]), size=0, device="cpu"))
