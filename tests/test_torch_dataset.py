"""The port's ``ValleDataset`` (in-memory audio items tokenized through the
codec encoder) against the JAX package's: bucketed ``precompute_codes`` gives
exactly the JAX codes and tokens; the disk cache round trip encodes nothing
and returns the same arrays, in the JAX package's file and key (either
package reads the other's cache); the key changes with the codec weights;
and a training batch collates from the tokenized items."""

import numpy as np
import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.codec import EncodecTPU
from valle2_tpu.config import ConfigValle as JConfig
from valle2_tpu.data.dataset import ValleDataset as JValleDataset
from valle2_tpu_torch.codec import Encodec
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.data import DataLoader, ValleDataset, get_collate, get_dataloaders
from valle2_tpu_torch.models.convert import codec_params_from_numpy

BUCKETS = (0.2,)          # one 4800-sample bucket: every item encodes in one batch


class FakeHF:
    """Sequence of HF-style items at three sample rates (16 / 22.05 / 24 kHz)."""

    def __init__(self, seed: int = 0):
        rs = np.random.RandomState(seed)
        rates = (16000, 22050, 24000, 24000)
        lengths = (2000, 3000, 4321, 1000)
        texts = ('the dog.', 'one two three.', 'a b.', 'hello there.')
        self.items = [{'audio': {'array': rs.randn(n) * 0.3, 'sampling_rate': sr},
                       'text': text} for sr, n, text in zip(rates, lengths, texts)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def counting(codec) -> dict:
    calls = {'n': 0}
    inner = codec.batch_encode

    def wrapped(audios):
        calls['n'] += 1
        return inner(audios)
    codec.batch_encode = wrapped
    return calls


@pytest.fixture(scope='module')
def jax_dataset():
    ds = JValleDataset(FakeHF(), JConfig(), EncodecTPU(seed=0))
    ds.precompute_codes(batch_size=16, length_buckets=BUCKETS)
    return ds


def port_codec(jax_ds) -> Encodec:
    """The port's codec on the JAX dataset codec's weights."""
    import jax
    return Encodec(params=codec_params_from_numpy(jax.tree.map(np.asarray,
                                                               jax_ds.codec.params)),
                   device='cpu')


def test_precompute_codes_match_jax(jax_dataset):
    ds = ValleDataset(FakeHF(), ConfigValle(), port_codec(jax_dataset))
    calls = counting(ds.codec)
    ds.precompute_codes(batch_size=16, length_buckets=BUCKETS)
    assert calls['n'] == 1
    for i in range(len(ds)):
        got, want = ds[i], jax_dataset[i]
        assert got['codes'].shape == want['codes'].shape
        np.testing.assert_array_equal(got['codes'], np.asarray(want['codes']))
        np.testing.assert_array_equal(got['tokens'], want['tokens'])
    assert ds[2]['codes'].shape == (8, -(-4321 // 320))
    assert ds._cache_key() == jax_dataset._cache_key()


def test_disk_cache_round_trip_encodes_nothing(jax_dataset, tmp_path):
    codec = port_codec(jax_dataset)
    first = ValleDataset(FakeHF(), ConfigValle(), codec)
    first.precompute_codes(batch_size=16, length_buckets=BUCKETS, cache_dir=tmp_path)
    second = ValleDataset(FakeHF(), ConfigValle(), port_codec(jax_dataset))
    calls = counting(second.codec)
    second.precompute_codes(batch_size=16, length_buckets=BUCKETS, cache_dir=tmp_path)
    assert calls['n'] == 0
    for i in range(len(first)):
        np.testing.assert_array_equal(second[i]['codes'], first[i]['codes'])
        np.testing.assert_array_equal(second[i]['tokens'], first[i]['tokens'])
        assert second[i]['codes'].dtype == np.int32
    # The JAX package reads the port's file, with its own key.
    jds = JValleDataset(FakeHF(), JConfig(), jax_dataset.codec)
    assert jds._load_disk_cache(tmp_path)
    np.testing.assert_array_equal(jds[1]['codes'], first[1]['codes'])
    # Other codec weights: another key, so the file is not used.
    other = ValleDataset(FakeHF(), ConfigValle(), Encodec(seed=1, device='cpu'))
    assert other._cache_key() != first._cache_key()
    assert not other._load_disk_cache(tmp_path)
    # A training batch from the tokenized items.
    cfg = ConfigValle()
    batch = next(iter(DataLoader(first, 2, get_collate('ValleAR')(cfg))))
    assert batch['codes'].shape[0] == 2


def test_getitem_encodes_solo_and_hf_loading_still_raises(jax_dataset):
    """An item taken before any precompute is encoded alone: equal to the JAX
    package's solo encode, and to the bucketed codes but for the last two
    frames (the bucket's zero padding reaches them through the strided
    convs' reflect padding)."""
    ds = ValleDataset(FakeHF(), ConfigValle(), port_codec(jax_dataset))
    solo = ds[2]['codes']
    want = JValleDataset(FakeHF(), JConfig(), jax_dataset.codec)[2]['codes']
    assert solo.shape == (8, 14)
    np.testing.assert_array_equal(solo, np.asarray(want))
    np.testing.assert_array_equal(solo[:, :-2], np.asarray(jax_dataset[2]['codes'])[:, :-2])
    with pytest.raises(NotImplementedError, match='load_dataset'):
        get_dataloaders('ValleAR', ConfigValle())


def test_codec_ckpt_reaches_the_dataset_codec(tmp_path):
    """``config.codec_ckpt`` (and the ASR direction) pass the config's gate,
    and a dataset built without a codec loads that checkpoint, as the JAX
    package's loader does."""
    import torch
    from torch_encodec_mirror import EncodecMirror
    mirror = EncodecMirror(seed=2)
    torch.save({'best_state': mirror.state_dict()}, tmp_path / 'encodec.th')
    cfg = ConfigValle(codec_ckpt=str(tmp_path / 'encodec.th'), direction='asr')
    ds = ValleDataset(FakeHF(), cfg, device='cpu')
    want = Encodec(checkpoint=str(tmp_path / 'encodec.th'), device='cpu')
    assert ds.codec.fingerprint() == want.fingerprint()
    assert ds.codec.fingerprint() != Encodec(seed=0, device='cpu').fingerprint()
