"""The port's packed image datasets against exsr's: the blob and its index
byte-equal, decoded images equal, LR/HR pairs within 1e-6 (the LR is
``imresize`` in float64 in both packages), the training crops drawn alike
from the same seed."""
import numpy as np
import pytest
from PIL import Image

from exsr.data import packed as X
from exsr_torch.data import packed as T


@pytest.fixture(scope='module')
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp('pack')
    d = root / 'imgs'
    (d / 'sub').mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, (h, w) in (('b.png', (50, 66)), ('a.png', (64, 48)),
                         ('sub/c.png', (41, 43))):
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255)
                        .astype(np.uint8)).save(d / name)
    Image.fromarray((rng.uniform(size=(20, 20)) * 255).astype(np.uint8)) \
        .save(d / 'grey.png')
    nx = X.pack_images(str(d), str(root / 'x.pack'))
    nt = T.pack_images(str(d), str(root / 't.pack'))
    assert nx == nt == 4
    return root


def test_pack_images_equals_exsr(pack):
    assert (pack / 'x.pack').read_bytes() == (pack / 't.pack').read_bytes()
    assert (pack / 'x.pack.json').read_text() == \
        (pack / 't.pack.json').read_text()
    xd = X.PackedImageDataset(str(pack / 'x.pack'))
    td = T.PackedImageDataset(str(pack / 't.pack'))
    assert len(td) == len(xd) == 4
    for i in range(len(td)):
        assert td.name(i) == xd.name(i)
        a, b = td.read(i), xd.read(i)
        assert a.dtype == np.float32 and a.shape[-1] == 3
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('train', [False, True])
def test_packed_lrhr_dataset_equals_exsr(pack, train):
    kw = dict(scale=4, patch_size=16 if train else None, train=train)
    xd = X.PackedLRHRDataset(str(pack / 'x.pack'), **kw)
    td = T.PackedLRHRDataset(str(pack / 't.pack'), **kw)
    assert len(td) == len(xd)
    for i in range(len(td)):
        a = td.__getitem__(i, np.random.default_rng(i))
        b = xd.__getitem__(i, np.random.default_rng(i))
        assert a['path'] == b['path']
        for k in ('lr', 'hr'):
            assert a[k].shape == b[k].shape and a[k].dtype == np.float32
            assert np.abs(a[k] - b[k]).max() <= 1e-6, k
        if not train:
            h, w = a['hr'].shape[:2]
            assert h % 4 == 0 and w % 4 == 0
            assert a['lr'].shape[:2] == (h // 4, w // 4)
        else:
            assert a['hr'].shape == (16, 16, 3)
