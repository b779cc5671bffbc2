"""Row sharding leaves the PLM tower's word table replicated, in the port
and in the JAX package alike: the rule takes names ending
``embedding.weight`` (JAX ``embedding/embedding``,
``newsreclib_tpu/parallel/mesh.py:60``), and the tower's table is
``word_embeddings.weight`` (JAX ``word_embeddings/embedding``).
``tests/test_torch_port_parallel.py`` holds the port's rule on the names
alone, and ``place_state``'s two refusals; this file holds the JAX rule on
the same model's flax parameters and the placed state itself.  No process
group is needed: nothing is sharded.
"""

import jax
import numpy as np
import torch

from newsreclib_tpu_torch.parallel.mesh import Mesh, place_state, shard_specs
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

VOCAB = 300


def _grid(model_axis=2):
    """Rank 0 of a (1, model_axis) grid without process groups."""
    return Mesh(0, model_axis, model_axis, torch.device("cpu"), "gloo", None, None)


def _plm_nrms():
    from newsreclib_tpu_torch.models.components.plm import PLMTextEncoder, TransformerEncoder
    from newsreclib_tpu_torch.models.general_rec import NRMS

    g = torch.Generator().manual_seed(0)
    enc = TransformerEncoder(VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
                             intermediate_dim=64, max_position=64, dropout=0.0, generator=g)
    tower = PLMTextEncoder(enc, use_mhsa=True, num_heads=4, query_dim=16, dropout=0.0,
                           generator=g)
    return NRMS(VOCAB, embed_dim=32, num_heads=4, query_dim=16, dropout=0.0,
                text_encoder_module=tower, text_encoder_dim=32, device="cpu", generator=g)


def _shapes(model):
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def test_row_sharding_leaves_the_plm_word_table_replicated_as_jax():
    """At model axis 2 the GloVe NRMS's word table is row-sharded, the PLM
    NRMS's tower tables are not (in the port's rule and in JAX's
    ``param_shardings`` over the same model's flax parameters), and
    ``place_state`` leaves the tower's table whole with no lookup hook."""
    from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu.models.components.plm import PLMTextEncoder as JTower
    from newsreclib_tpu.models.components.plm import TransformerEncoder as JEncoder
    from newsreclib_tpu.models.general_rec import NRMS as JNRMS
    from newsreclib_tpu.parallel.mesh import make_mesh, param_shardings
    from newsreclib_tpu_torch.models.general_rec import NRMS

    glove = NRMS(VOCAB, embed_dim=32, num_heads=4, query_dim=16, device="cpu")
    assert shard_specs(_shapes(glove), 2) == {"news_encoder.embedding.weight": 0}

    model = _plm_nrms()
    table = "text_encoder_module.encoder.word_embeddings.weight"
    assert table in _shapes(model)
    assert shard_specs(_shapes(model), 2) == {}
    assert shard_specs(_shapes(model), 2, tp_transformer=True).get(table) is None

    state = place_state(create_train_state(model, make_optimizer(1e-3)), _grid())
    assert state.sharded == {}
    words = state.model.text_encoder_module.encoder.word_embeddings
    assert tuple(words.weight.shape) == (VOCAB, 32) and getattr(words, "shard", None) is None

    jtower = JTower(encoder=JEncoder(vocab_size=VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
                                     intermediate_dim=64, max_position=64),
                    use_mhsa=True, num_heads=4, query_dim=16)
    jm = JNRMS(vocab_size=VOCAB, embed_dim=32, num_heads=4, query_dim=16,
               text_encoder_module=jtower)
    batch = make_batch(np.random.default_rng(0), batch_size=2, hist_len=4, num_candidates=3,
                       unique_news=8, cfg=SyntheticConfig(vocab_size=VOCAB, title_len=12))
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0), batch))["params"]
    specs = param_shardings(params, make_mesh(jax.devices()[:2], model_axis=2))
    flat = {"/".join(str(p.key) for p in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    jtable = [k for k in flat if k.endswith("word_embeddings/embedding")]
    assert len(jtable) == 1 and flat[jtable[0]] == jax.sharding.PartitionSpec()
    assert all(s == jax.sharding.PartitionSpec() for s in flat.values())
