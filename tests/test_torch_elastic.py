"""The port's ElasticTrainer (``train/elastic.py``) against the JAX
package's, on the CPU: ``tests/test_elastic.py``'s reform-to-fewer-places
scenario on both packages from shared weights. 5 steps on 8 places
({dp 2, fsdp 4}; a checkpoint at step 5), the reform onto 4 places
({fsdp 4}) restoring that checkpoint into the new mesh's shardings, 2
more steps: the parameters agree within 1e-5 after the 5 steps, after the
reform and after the 7, and the port's restore is bit-equal to what it
saved. The reform's seconds go to the run's restart bucket.
"""

import jax
import numpy as np

from ray_tpu.models import llama as jllama
from ray_tpu.train.elastic import ElasticTrainer as JaxElasticTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch import convert
from ray_tpu_torch.parallel.sharding import ShardedTensor, place_tree
from ray_tpu_torch.train import telemetry
from ray_tpu_torch.train.elastic import ElasticTrainer
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig

KW = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
          d_ff=64, head_dim=8, remat="none", dtype="float32")


def _axes_fn(n):
    # prefer dp x fsdp factorizations (tests/test_elastic.py)
    if n % 4 == 0:
        return {"dp": n // 4, "fsdp": 4}
    if n % 2 == 0:
        return {"dp": n // 2, "fsdp": 2}
    return {"dp": n}


def _batches(n, batch=8, seq=17, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)
            for _ in range(n)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, ShardedTensor):
        tree = tree.unshard()
    return {prefix[:-1]: np.asarray(tree.detach() if hasattr(
        tree, "detach") else tree)}


def _err(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def test_reform_to_fewer_places_matches_jax(tmp_path):
    tc = dict(total_steps=100, warmup_steps=1)
    jet = JaxElasticTrainer(
        jllama.LlamaConfig(**KW), JaxTrainConfig(**tc),
        checkpoint_dir=str(tmp_path / "jax"), mesh_axes_fn=_axes_fn,
        devices=jax.devices()[:8], checkpoint_every=5)
    et = ElasticTrainer(
        tllama.LlamaConfig(**KW), TrainConfig(**tc),
        checkpoint_dir=str(tmp_path / "torch"), mesh_axes_fn=_axes_fn,
        devices=["cpu"] * 8, checkpoint_every=5, run_name="elastic-parity")
    assert et.trainer.mesh.shape == {"dp": 2, "fsdp": 4}
    jstate = jet.init_state(jax.random.key(0))
    params = convert.params_from_numpy(
        et.model_cfg, jax.tree.map(np.asarray, jstate.params), device="cpu")
    state = place_tree(TrainState.create(params, et.trainer.optimizer),
                       et.trainer.state_shardings())
    batches = _batches(7)
    jstate = jet.fit(jstate, iter(batches[:5]), steps=5)
    state = et.fit(state, iter(batches[:5]), steps=5)
    et.ckpt.wait()
    assert et.ckpt.all_steps() == [5]
    before = _flat(state.params)
    assert _err(before, _flat(jax.tree.map(np.asarray,
                                           jstate.params))) <= 1e-5

    jstate = jet.reform(devices=jax.devices()[:4])
    state = et.reform(devices=["cpu"] * 4)
    assert et.trainer.mesh.shape == {"dp": 1, "fsdp": 4}
    assert state.step == 5 and state.opt_state["count"] == 5
    assert _err(_flat(state.params), before) == 0.0
    assert all(isinstance(t, ShardedTensor) and t.mesh.size == 4
               for t in _flat_leaves(state.params))
    assert _err(_flat(state.params), _flat(jax.tree.map(
        np.asarray, jstate.params))) <= 1e-5

    jstate = jet.fit(jstate, iter(batches[5:]), steps=2)
    state = et.fit(state, iter(batches[5:]), steps=2)
    assert state.step == 7 == int(jstate.step)
    assert _err(_flat(state.params), _flat(jax.tree.map(
        np.asarray, jstate.params))) <= 1e-5
    ev, = et.reform_events
    assert (ev.step, ev.old_devices, ev.new_devices) == (5, 8, 4)
    assert telemetry.run_goodput("elastic-parity")["restart"] == \
        ev.seconds
    assert et.telemetry.step == 7
    jet.close()
    et.close()


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_leaves(v)]
    return [tree]
