"""``--remat_policy`` without ``--remat`` is refused by both packages.

The JAX package raises in ``plm_config`` (``miner_tpu/config.py``), which
``Trainer.build_model`` reaches in every subcommand that builds a model; the
port raises the same ``ValueError`` when its ``Trainer`` is made. With
``--remat`` both take the flag (the port then recomputes whole layers: the
``dots`` policy itself is not ported).
"""
import os

import pytest

from miner_tpu.config import plm_config as jax_plm_config
from miner_tpu_torch.config import make_parser
from miner_tpu_torch.training.trainer import Trainer
from tests.fixture_data import make_fixture

REFUSAL = ("--remat_policy 'dots' has no effect without --remat; pass --remat "
           "(or drop --remat_policy)")
SUBCOMMANDS = {"train": (), "train_fastformer": (), "pretrain": (), "eval": (), "serve": (),
               "recommend": ("--user_history", "N1")}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("remat_policy")), num_lines=8)


def _port_trainer(fixture, mode, *extra):
    return Trainer(make_parser().parse_args([
        mode, "--pretrained_tokenizer", "hash:1000", "--plm_preset", "tiny",
        "--user2id_path", os.path.join(fixture, "user2id.json"),
        "--category2id_path", os.path.join(fixture, "category2id.json"),
        "--device", "cpu", "--remat_policy", "dots", *extra]))


def _build(package, fixture, remat):
    """What each package builds from --remat_policy dots (and --remat)."""
    if package == "jax":
        return jax_plm_config("tiny", vocab_size=1000, remat=remat, remat_policy="dots")
    return _port_trainer(fixture, "train", *(["--remat"] if remat else []))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_remat_policy_without_remat_is_refused(fixture_dir, package):
    with pytest.raises(ValueError) as err:
        _build(package, fixture_dir, remat=False)
    assert str(err.value) == REFUSAL


@pytest.mark.parametrize("package", ["jax", "port"])
def test_remat_policy_with_remat_is_taken(fixture_dir, package):
    built = _build(package, fixture_dir, remat=True)
    if package == "jax":
        assert built.remat and built.remat_policy == "dots"
    else:
        assert built.args.remat and built.args.remat_policy == "dots"


@pytest.mark.parametrize("mode", SUBCOMMANDS)
def test_every_subcommand_of_the_port_refuses_it(fixture_dir, mode):
    with pytest.raises(ValueError, match="has no effect without --remat"):
        _port_trainer(fixture_dir, mode, *SUBCOMMANDS[mode])
    taken = _port_trainer(fixture_dir, mode, "--remat", *SUBCOMMANDS[mode])
    assert taken.args.remat_policy == "dots"
