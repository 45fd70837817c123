"""The reference's expert-parallel MoE on two XLA CPU devices, for
``test_torch_ep.py`` (run as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``; the device count
is fixed when JAX starts):

    python tests/_torch_ep_ref.py IN.npz OUT.npz

On a (data=2, model=1) mesh and qwen3-moe-30b-a3b's ``scaled_down()``
sizes in f32, with the weights of ``jax.random.key(0)`` (saved as
``p/<leaf path>``): ``moe_apply`` on layer 0's block (the auto route on
one device, EP with and without ``moe_a2a_quant``); ``_a2a_quantized`` on
a fed buffer; prefill and fed decode steps through ``make_prefill_step``
/ ``make_decode_step`` with ``moe_impl="ep"``; the summed gradients of
the weighted client losses inside the train step's ``shard_map`` (the
replicated leaves ``psum``-ed, the expert leaves as the exchange's
backward leaves them); and two train steps under each aggregator, with
and without ``moe_a2a_quant``, their losses and final parameters.
"""
import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.sharding import ShardingRules
from repro.launch.steps import (_restrict_spec, fl_round_arrays,
                                make_decode_step, make_prefill_step,
                                make_train_step)
from repro.models import api, layers as L, make_model
from repro.optim.sgd import SGDConfig

ARCH = "qwen3-moe-30b-a3b"


def _flat(tree, prefix):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(v)
    return out


def _jit(sb):
    return jax.jit(sb.fn, in_shardings=sb.in_shardings,
                   out_shardings=sb.out_shardings)


def main(inp_path, out_path):
    inp = dict(np.load(inp_path))
    cfg = get_config(ARCH).scaled_down()
    model = make_model(cfg)
    params = model.init(jax.random.key(0))
    mesh = make_host_mesh(model_axis=1, data_axis=2)
    out = _flat(params, "p/")

    # the block on layer 0
    moe = jax.tree.map(lambda v: v[0], params["groups"]["b0"]["moe"])
    x = jnp.asarray(inp["x"])
    y, aux = L.moe_apply(cfg, moe, x)
    out["moe/auto_y"], out["moe/auto_aux"] = np.asarray(y), np.asarray(aux)
    for tag, quant in (("ep", False), ("ep_quant", True)):
        fn = jax.jit(lambda p_, x_, q=quant: L.moe_apply(
            cfg, p_, x_, {"moe_impl": "ep", "mesh": mesh,
                          "moe_a2a_quant": q}))
        y, aux = fn(moe, x)
        out[f"moe/{tag}_y"], out[f"moe/{tag}_aux"] = (np.asarray(y),
                                                      np.asarray(aux))

    # the int8 exchange on a fed buffer: each device's (2, E_loc, C, d)
    qa2a = compat.shard_map(lambda u: L._a2a_quantized(u, "data"), mesh,
                            in_specs=P("data"), out_specs=P("data"),
                            manual_axes=("data",))
    out["a2a/out"] = np.asarray(jax.jit(qa2a)(jnp.asarray(inp["u"])))

    # prefill, then fed decode steps, on the mesh
    flags = {"moe_impl": "ep"}
    B, S = inp["prompt"].shape
    steps = inp["feed"].shape[1]
    cache_len = S + steps + 1
    pre = make_prefill_step(model, mesh, batch=B, seq=S,
                            cache_len=cache_len, flags=flags)
    logits, caches, memory = _jit(pre)(params,
                                       {"tokens": jnp.asarray(inp["prompt"])})
    out["serve/prefill"] = np.asarray(logits)
    dec = _jit(make_decode_step(model, mesh, batch=B, cache_len=cache_len,
                                flags=flags))
    kept = []
    for i in range(steps):
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, caches = dec(params, jnp.asarray(inp["feed"][:, i:i + 1]),
                             pos, caches, memory)
        kept.append(np.asarray(logits))
    out["serve/decode"] = np.stack(kept)

    # the weighted clients' gradients, summed as the train step sums them
    caxes = ("data",)
    pspecs = ShardingRules.default().tree_specs(mesh, model.abstract_params(),
                                                model.axes)
    manual = jax.tree.map(lambda s: _restrict_spec(s, caxes), pspecs,
                          is_leaf=lambda s: isinstance(s, P))
    skip = jax.tree.map(lambda s: len(s) > 0, manual,
                        is_leaf=lambda s: isinstance(s, P))
    gflags = {"moe_impl": "ep", "mesh": mesh, "_in_manual": True}

    def body(p, tokens, w):
        def local(q):
            loss, _ = api.loss_fn(model, q, {"tokens": tokens}, gflags)
            return loss * w.reshape(())
        g = jax.grad(local)(p)
        return jax.tree.map(lambda g_, s: g_ if s else jax.lax.psum(g_, caxes),
                            g, skip)

    grads = jax.jit(compat.shard_map(
        body, mesh, in_specs=(manual, P("data"), P("data")),
        out_specs=manual, manual_axes=caxes))(
            params, jnp.asarray(inp["tokens"][0]),
            jnp.asarray(inp["gammas"], jnp.float32))
    out.update(_flat(grads, "grad/"))
    out["skip"] = np.array([bool(s) for s in jax.tree.leaves(skip)])

    # train steps
    Bt, St = inp["tokens"].shape[1:]
    for quant, agg in itertools.product((False, True),
                                        ("ideal", "ota", "digital")):
        tag = agg + ("_quant" if quant else "")
        sb = make_train_step(model, mesh, aggregator=agg,
                             sgd=SGDConfig(eta=float(inp["eta"])), batch=Bt,
                             seq=St, flags={"moe_impl": "ep",
                                            "moe_a2a_quant": quant})
        f = _jit(sb)
        p, losses = params, []
        for t in range(inp["tokens"].shape[0]):
            fl = fl_round_arrays(mesh, gammas=inp["gammas"], alpha=2.0,
                                 noise_scale=1e-3, levels=15.0)
            p, loss = f(p, {"tokens": jnp.asarray(inp["tokens"][t])}, fl,
                        jax.random.key(t))
            losses.append(float(loss))
        out[f"train/{tag}/losses"] = np.array(losses)
        out.update(_flat(p, f"train/{tag}/"))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
