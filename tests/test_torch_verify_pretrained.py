"""The port's pretrained-artifact gate (``valle2_tpu_torch/tools/verify_pretrained.py``)
through the cases of the JAX tool's tests (``tests/test_verify_pretrained.py``):
a synthesized EnCodec checkpoint (saved from the weight-normed torch mirror
with the real state-dict naming) passes every stage on the CPU; the gate
fails when the reference loads other weights, so it is not vacuous; exit
codes; a reference-named AR checkpoint decodes and its greedy ids equal the
torch reference modules' step-by-step decode (and a checkpoint of other
weights fails that stage); the frontend gate skips without g2p_en.  Both
tools agree stage by stage on the same files."""

import json

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

from valle2_tpu.tools import verify_pretrained as jvp
from valle2_tpu_torch.config import ConfigValle
from valle2_tpu_torch.tools import verify_pretrained as vp

AR_CFG = dict(d_model=32, n_heads=2, dim_feedforward=64, num_layers=2, norm='LayerNorm',
              dropout=0.0)


@pytest.fixture(scope='module')
def codec_ckpt(tmp_path_factory):
    from torch_encodec_mirror import EncodecMirror
    path = tmp_path_factory.mktemp('artifacts') / 'encodec_24khz.th'
    torch.save({'best_state': EncodecMirror(seed=7).state_dict()}, path)
    return path


class TestCodecGate:
    def test_good_checkpoint_passes_every_stage(self, codec_ckpt):
        results = vp.verify_codec(str(codec_ckpt), verbose=False, device='cpu')
        assert results and all(results.values()), results
        assert any('encode-token-parity' in k for k in results)

    def test_divergence_is_detected_not_vacuous(self, codec_ckpt, monkeypatch):
        from torch_encodec_mirror import EncodecMirror
        other = EncodecMirror(seed=8).state_dict()
        monkeypatch.setattr(vp, '_references',
                            lambda sd: [('wrong-weights', vp._MirrorReference(other))])
        results = vp.verify_codec(str(codec_ckpt), verbose=False, device='cpu')
        assert not all(results.values())
        assert vp.main(['--codec', str(codec_ckpt), '--device', 'cpu']) == 1

    def test_cli_exit_codes(self, codec_ckpt, capsys):
        assert vp.main(['--codec', str(codec_ckpt), '--device', 'cpu']) == 0
        out = capsys.readouterr().out
        assert 'PASS' in out and 'stages passed' in out
        with pytest.raises(SystemExit):
            vp.main([])                               # nothing to verify


def ar_checkpoint(path, seed=0):
    from torch_reference_modules import ReferenceShapedValleAR
    torch.manual_seed(seed)
    model = ReferenceShapedValleAR(ConfigValle(**AR_CFG))
    if seed:
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.2)
    torch.save({'state_dict': {f'model.{k}': v for k, v in model.state_dict().items()}}, path)
    return path


class TestValleGate:
    def test_ar_checkpoint_greedy_parity_and_agreement_with_jax_tool(self, tmp_path):
        from valle2_tpu.config import ConfigValle as JConfig
        path = ar_checkpoint(tmp_path / 'ar.ckpt')
        results = vp.verify_valle(str(path), 'ValleAR', ConfigValle(**AR_CFG), device='cpu')
        assert results == {'ar-decode-finite': True,
                           'ar-greedy-parity[torch-reference]': True}
        jres = jvp.verify_valle(str(path), 'ValleAR', JConfig(**AR_CFG))
        assert jres == {'ar-decode-finite': True, 'ar-greedy-parity[torch-mirror]': True}

    def test_greedy_parity_fails_against_other_weights(self, tmp_path, monkeypatch):
        path = ar_checkpoint(tmp_path / 'ar.ckpt')
        other = torch.load(ar_checkpoint(tmp_path / 'other.ckpt', seed=5),
                           weights_only=True)['state_dict']
        real = vp._reference_greedy
        monkeypatch.setattr(vp, '_reference_greedy',
                            lambda sd, *a: real(other, *a))
        results = vp.verify_valle(str(path), 'ValleAR', ConfigValle(**AR_CFG), device='cpu')
        assert results['ar-greedy-parity[torch-reference]'] is False
        (tmp_path / 'cfg.json').write_text(json.dumps(AR_CFG))
        assert vp.main(['--ar', str(path), '-c', str(tmp_path / 'cfg.json'),
                        '--device', 'cpu']) == 1

    def test_nar_checkpoint_decodes(self, tmp_path):
        from valle2_tpu_torch.models import nar as tnar
        from valle2_tpu_torch.models.convert import save_torch_checkpoint
        cfg = ConfigValle(**dict(AR_CFG, norm='AdaptiveLayerNorm'))
        save_torch_checkpoint(tmp_path / 'nar.ckpt',
                              tnar.init_params(torch.Generator().manual_seed(0), cfg),
                              'ValleNAR')
        assert vp.verify_valle(str(tmp_path / 'nar.ckpt'), 'ValleNAR', cfg,
                               device='cpu') == {'nar-decode-finite': True}


class TestFrontendGate:
    def test_skips_cleanly_without_g2p(self):
        out = vp.verify_frontend(verbose=False)
        if not out['available']:
            assert out == {'available': False} == jvp.verify_frontend(verbose=False)
            assert vp.main(['--frontend']) == 0
        else:
            assert 0.0 <= out['phoneme_agreement'] <= 1.0
