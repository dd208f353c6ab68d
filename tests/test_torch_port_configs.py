"""The port's recipe registry (`mtp_tpu_torch.configs`) against mtp_tpu's:
the same names, and each recipe field for field (name, task config,
dataset, init tag, notes; the JAX layout field `scan` as JAX sets it)."""

import dataclasses

import pytest

from mtp_tpu import configs as jconfigs
from mtp_tpu_torch import configs as pconfigs

NAMES = jconfigs.available()


def test_available_lists_the_same_names():
    assert pconfigs.available() == NAMES
    assert len(NAMES) == 100
    kinds = [pconfigs.get(n).task.task for n in NAMES]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "change_detection": 25, "detection_r": 25, "classification": 16,
        "segmentation": 13, "detection_h": 12, "instseg": 6, "multitask": 3}


@pytest.mark.parametrize("name", NAMES)
def test_recipe_matches_jax(name):
    want, got = jconfigs.get(name), pconfigs.get(name)
    assert type(got).__name__ == "Recipe"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # a fresh recipe each call, as in JAX
    assert pconfigs.get(name) == got and pconfigs.get(name) is not got


def test_aliases_and_unknown_names():
    for alias, target in pconfigs._ALIASES.items():
        got = pconfigs.get(alias)
        assert got.name == alias
        assert dataclasses.asdict(got.task) == dataclasses.asdict(pconfigs.get(target).task)
        assert dataclasses.asdict(got) == dataclasses.asdict(jconfigs.get(alias))
    with pytest.raises(KeyError):
        pconfigs.get("no-such-recipe")


def test_register_adds_a_recipe(monkeypatch):
    monkeypatch.setattr(pconfigs, "_REGISTRY", dict(pconfigs._REGISTRY))
    base = pconfigs.get("rvsa-b-upernet-384-mae-mtp-spacenetv1")

    @pconfigs.register("toy")
    def _():
        return dataclasses.replace(base, name="toy")

    assert "toy" in pconfigs.available() and pconfigs.get("toy").name == "toy"
