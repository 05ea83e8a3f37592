"""The port's device fence (``bodywork_tpu_torch.utils.sync.fence``)
against the JAX package's (``bodywork_tpu.utils.sync.fence``): the same
five contracts as ``tests/test_sync.py`` on the same inputs. The JAX
fence fetches one scalar per array leaf; the port's synchronizes each
CUDA device that holds a non-empty tensor once (a device runs its work
in launch order), so its counting contract counts devices."""
import jax.numpy as jnp
import numpy as np
import torch

from bodywork_tpu.utils.sync import fence as jax_fence
from bodywork_tpu_torch.utils.sync import fence

torch.set_num_threads(1)


def test_fence_returns_input_identity():
    x = torch.arange(4.0)
    assert fence(x) is x
    y = jnp.arange(4.0)
    assert jax_fence(y) is y


def test_fence_pytree_and_non_array_leaves():
    tree = {
        "a": torch.ones((2, 3)),
        "b": [np.arange(3), "not-an-array", 7],
        "c": {"empty": torch.zeros((0,)), "scalar": torch.tensor(1.5)},
    }
    assert fence(tree) is tree
    jax_tree = {
        "a": jnp.ones((2, 3)),
        "b": [np.arange(3), "not-an-array", 7],
        "c": {"empty": jnp.zeros((0,)), "scalar": jnp.float32(1.5)},
    }
    assert jax_fence(jax_tree) is jax_tree


def test_fence_forces_computation_result_visible():
    x = torch.full((16,), 2.0)
    y = fence(x * 3.0)
    np.testing.assert_allclose(y.numpy(), 6.0)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax_fence(jnp.full((16,), 2.0) * 3.0)))


class _CardLeaf:
    """A stand-in for a tensor on a card (the CPU has none): what the
    fence reads of a leaf is its ``device`` and ``numel``."""

    def __init__(self, index: int, numel: int = 4):
        self.device = torch.device("cuda", index)
        self._numel = numel

    def numel(self) -> int:
        return self._numel


def test_fence_synchronizes_each_card_once(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    tree = {"a": _CardLeaf(0), "b": [_CardLeaf(0), np.arange(3), "skip", 7],
            "c": _CardLeaf(1), "empty": _CardLeaf(2, numel=0), "host": torch.ones(3)}
    assert fence(tree) is tree
    # cards 0 and 1 once each; host leaves, strings, ints and an empty
    # tensor need no wait
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]
    synced.clear()
    fence({"host": torch.ones(3), "np": np.ones(2)})
    assert synced == []


def test_fence_list_of_results_fences_each():
    outs = [torch.arange(3.0) + i for i in range(4)]
    assert fence(outs) is outs
    jax_outs = [jnp.arange(3.0) + i for i in range(4)]
    assert jax_fence(jax_outs) is jax_outs
    for a, b in zip(outs, jax_outs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
