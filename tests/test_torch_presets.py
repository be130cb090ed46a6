"""The port's model presets against the JAX package's, and the CLIs that
take them (ROADMAP 3, fault 2): every preset the reference names exists in
the port with the same values, and each CLI parses it."""

import dataclasses

import pytest

from bioreason_tpu import config as JC
from bioreason_tpu.cli import common as JCommon
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.cli import common as TCommon


def _shared(port, ref) -> dict:
    """The reference config's values on the port's fields (the JAX configs
    carry fields of slices not ported yet, MoE among them)."""
    names = {f.name for f in dataclasses.fields(port)}
    return {k: v for k, v in dataclasses.asdict(ref).items() if k in names}


@pytest.mark.parametrize("name", sorted(JCommon.DECODER_PRESETS))
def test_decoder_presets_equal_jax(name):
    ours, ref = TCommon.DECODER_PRESETS[name](), JCommon.DECODER_PRESETS[name]()
    assert dataclasses.asdict(ours) == _shared(ours, ref)


@pytest.mark.parametrize("name", sorted(JCommon.ENCODER_PRESETS))
def test_encoder_presets_equal_jax(name):
    ours, ref = TCommon.ENCODER_PRESETS[name](), JCommon.ENCODER_PRESETS[name]()
    assert dataclasses.asdict(ours) == _shared(ours, ref)
    assert ours.head_dim == ref.head_dim


@pytest.mark.parametrize("method", ["qwen3_0_6b", "qwen3_1_7b", "qwen3_4b"])
def test_decoder_preset_methods_equal_jax_at_a_vocab(method):
    ours = getattr(TC.DecoderConfig, method)(vocab_size=1234)
    assert dataclasses.asdict(ours) == _shared(
        ours, getattr(JC.DecoderConfig, method)(vocab_size=1234))


@pytest.mark.parametrize("cli", ["train_sft", "reason", "serve", "train_dna_only"])
@pytest.mark.parametrize("decoder,encoder", [("qwen3-4b", "nt-50m"), ("qwen3-1.7b", "nt-250m")])
def test_every_cli_parses_the_presets(cli, decoder, encoder):
    import importlib
    mod = importlib.import_module("bioreason_tpu_torch.serve" if cli == "serve"
                                  else f"bioreason_tpu_torch.cli.{cli}")
    argv = ["--encoder", encoder] + ([] if cli == "train_dna_only" else ["--decoder", decoder])
    args = mod.parse_args(argv)
    assert args.encoder == encoder
    assert cli == "train_dna_only" or args.decoder == decoder
