"""Weights for the port's parity tests, in the JAX package's layout.

``init_params`` and ``init_gate_params`` give the trees of
``repro.models.transformer.init_params`` / ``init_gate_params`` (their
shapes, from ``jax.eval_shape``), drawn with numpy from a seed by the
law the JAX init gives each leaf (LAWS). Running the JAX init op by op
costs seconds for each new config in a test process; these cost
milliseconds. Both packages then compute with one set of weights
(through repro_torch.bridge), so the draws themselves do not matter to
a parity test.

Only the families in FAMILIES are known here. A config of another
family, or a leaf whose name LAWS does not list, raises: a new family's
leaves (an LRU's lambda, an SSM's A_log, D or conv_b) need their own law
added here first.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as JT

FAMILIES = ("dense", "moe", "vlm", "encdec")


def _normal(scale):
    return lambda shape, rng: scale * rng.randn(*shape)


def _fan_in(shape, rng):
    # dense "w" [.., in, out] and the experts [.., E, in, out]
    return (1 / np.sqrt(shape[-2])) * rng.randn(*shape)


# the JAX init's law of each leaf, by the last keys of its path
# (repro.models.transformer.init_params / init_gate_params and
# repro.models.blocks.init_ffn / init_attn_proj / init_block /
# init_block_gate)
LAWS = {
    ("embed",): _normal(0.02),
    ("scale",): lambda shape, rng: np.ones(shape),
    ("xgate",): lambda shape, rng: np.zeros(shape),
    ("w2", "w"): _normal(0.02),                    # the gate's output
    ("w",): _fan_in,
    ("gate_w",): _fan_in,
    ("up_w",): _fan_in,
    ("down_w",): _fan_in,
}
BIAS = ("b",)             # attention biases 0, gate biases gate_bias_init


def _law(keys, gate_bias):
    if tuple(keys[-1:]) == BIAS:
        value = 0.0 if gate_bias is None else gate_bias
        return lambda shape, rng: np.full(shape, value)
    for n in (2, 1):
        if tuple(keys[-n:]) in LAWS:
            return LAWS[tuple(keys[-n:])]
    raise KeyError(f"no init law for the JAX leaf {keys}: add it to LAWS")


def _draw(cfg_j, shapes, rng, gate_bias=None):
    if cfg_j.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg_j.family!r}: known families are {FAMILIES}")

    def leaf(path, sd):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        keys = [k for k in keys if isinstance(k, str)]
        x = _law(keys, gate_bias)(sd.shape, rng)
        return jnp.asarray(np.asarray(x, np.float32), sd.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_params(cfg_j, seed=0):
    """The JAX package's params tree of cfg_j (JAX arrays)."""
    shapes = jax.eval_shape(lambda k: JT.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    return _draw(cfg_j, shapes, np.random.RandomState(seed))


def init_gate_params(cfg_j, seed=1):
    """The JAX package's gate tree of cfg_j (JAX arrays)."""
    shapes = jax.eval_shape(lambda k: JT.init_gate_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    return _draw(cfg_j, shapes, np.random.RandomState(seed),
                 gate_bias=cfg_j.gate_bias_init)
