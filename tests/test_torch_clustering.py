"""The port's IDEC clustering tool (carel_tpu_torch/tools/clustering.py)
against carel_tpu/tools/clustering.py, on the CPU:

- the AutoEncoder forward from JAX's init (convert.py maps its Dense
  layers): z and the reconstruction within 1e-5 of JAX's;
- _student_t and _target_dist within 1e-6 of JAX's, _kmeans (a numpy copy)
  equal to it;
- train_idec from JAX's init on the two-blob data of tests/test_tools.py
  (20 pretraining epochs, 20 refinement steps), plain and with must-link
  and cannot-link pairs: the same assignments as JAX's and the same
  chi-squared test result (table equal, chi2 and p within rtol 1e-9);
- one pretraining epoch and two refinement steps: every parameter within
  Adam's 2 lr a step of JAX's, the centres and the soft assignments within
  1e-3. Over more steps the two drift apart further (after 20 epochs the
  params differ by up to 0.05, the soft assignments by up to 0.04): Adam
  turns the rounding of its smallest gradients into steps of +-lr (the
  2 lr bound), and the refinement's Student-t amplifies what the
  pretraining left; the assignments stay equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carel_tpu.tools.clustering import AutoEncoder as JAutoEncoder
from carel_tpu.tools.clustering import IdecConfig as JIdecConfig
from carel_tpu.tools.clustering import _kmeans as j_kmeans
from carel_tpu.tools.clustering import _student_t as j_student_t
from carel_tpu.tools.clustering import _target_dist as j_target_dist
from carel_tpu.tools.clustering import emotion_cluster_chi2 as j_chi2
from carel_tpu.tools.clustering import train_idec as j_train_idec

from carel_tpu_torch.convert import jax_params_to_state_dict
from carel_tpu_torch.tools.clustering import (AutoEncoder, IdecConfig,
                                              _kmeans, _student_t,
                                              _target_dist,
                                              emotion_cluster_chi2,
                                              train_idec)


def _blobs():
    """tests/test_tools.py's data: two separated Gaussian blobs."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.3, (40, 16))
    b = rng.normal(4, 0.3, (40, 16))
    return np.concatenate([a, b]).astype(np.float32)


def _init(data, z_dim, seed):
    params = JAutoEncoder(z_dim).init(jax.random.key(seed),
                                      jnp.asarray(data[:2]))["params"]
    return params, jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))


def test_autoencoder_forward_matches_jax():
    data = _blobs()
    params, state = _init(data, 4, 42)
    want_z, want_x = JAutoEncoder(4).apply({"params": params},
                                           jnp.asarray(data))
    model = AutoEncoder(16, 4)
    model.load_state_dict(state)
    with torch.no_grad():
        z, x_hat = model(torch.from_numpy(data))
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-5)


def test_soft_assignments_and_kmeans_match_jax():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(30, 4)).astype(np.float32)
    centers = rng.normal(size=(5, 4)).astype(np.float32)
    q = _student_t(torch.from_numpy(z), torch.from_numpy(centers))
    want_q = np.asarray(j_student_t(jnp.asarray(z), jnp.asarray(centers)))
    np.testing.assert_allclose(q.numpy(), want_q, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _target_dist(q).numpy(),
        np.asarray(j_target_dist(jnp.asarray(want_q))), rtol=0, atol=1e-6)
    for k, seed in ((3, 0), (5, 7), (40, 1)):  # k past len(z): all points
        np.testing.assert_array_equal(_kmeans(z, k, seed),
                                      j_kmeans(z, k, seed))


@pytest.mark.parametrize("constrained", [False, True])
def test_train_idec_matches_jax(constrained):
    data = _blobs()
    kw = dict(z_dim=4, n_clusters=2, pretrain_epochs=20, refine_steps=20,
              batch_size=32, lr=1e-3)
    links = {}
    if constrained:
        links = dict(must_link=np.asarray([[0, 1], [40, 41]]),
                     cannot_link=np.asarray([[0, 40], [5, 60]]))
    want, want_art = j_train_idec(data, JIdecConfig(**kw), **links)
    _, init = _init(data, 4, 42)
    got, art = train_idec(data, IdecConfig(**kw), device="cpu",
                          params=init, **links)
    np.testing.assert_array_equal(got, want)
    assert max((got[:40] == c).mean() for c in np.unique(got)) > 0.8
    emotions = np.asarray([0] * 40 + [1] * 40)
    res, want_res = emotion_cluster_chi2(got, emotions), j_chi2(want,
                                                                 emotions)
    np.testing.assert_array_equal(res["table"], want_res["table"])
    assert res["dof"] == want_res["dof"]
    np.testing.assert_allclose([res["chi2"], res["p_value"]],
                               [want_res["chi2"], want_res["p_value"]],
                               rtol=1e-9)
    assert res["p_value"] < 0.05


def test_first_steps_of_train_idec_match_jax():
    data = _blobs()
    kw = dict(z_dim=4, n_clusters=2, pretrain_epochs=1, refine_steps=2,
              batch_size=32, lr=1e-3)
    want, want_art = j_train_idec(data, JIdecConfig(**kw))
    _, init = _init(data, 4, 42)
    got, art = train_idec(data, IdecConfig(**kw), device="cpu", params=init)
    np.testing.assert_array_equal(got, want)
    params = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_art["params"]))
    steps = -(-len(data) // 32) + 2
    for name, w in params.items():
        assert float((art["params"][name] - w).abs().max()) <= \
            2 * 1e-3 * steps, name
    np.testing.assert_allclose(art["centers"], want_art["centers"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(art["q"], want_art["q"], rtol=0, atol=1e-3)
