"""JAX's random draws replayed for the port: the uniforms that the JAX
package's render_image (path mode, NEE) draws from its PRNG key, as the
explicit draws the port's render_image takes. Shared by the port's parity
tests (not a test file)."""

import numpy as np
import torch

import jax


def light_draws(key, m):
    """JAX _sample_light's uniforms from its key: (kf, kb) = split(key),
    the face uniform from kf, the two barycentric ones from kb."""
    kf, kb = jax.random.split(key)
    return np.concatenate([np.asarray(jax.random.uniform(kf, (m,)))[:, None],
                           np.asarray(jax.random.uniform(kb, (m, 2)))],
                          axis=1)


def jax_nee_draws(spp, bounces, n, stride):
    """The draws of JAX's render_image (path, NEE) from PRNGKey(0): with
    spp > 1, split(key, spp) and per sample (kj, ks) = split, jitter from
    kj; per bounce (key, kl) = split(key), the light uniforms from kl
    (light_draws), (key, sub) = split(key), the bounce uniforms from
    sub."""
    keys = (jax.random.split(jax.random.PRNGKey(0), spp) if spp > 1
            else [None])
    jit, bnc, lgt = [], [], []
    for k in keys:
        if k is None:
            ks = jax.random.PRNGKey(0)
        else:
            kj, ks = jax.random.split(k)
            jit.append(np.asarray(jax.random.uniform(kj, (1, n, 2)))[0])
        b_draws, l_draws = [], []
        for _ in range(bounces):
            ks, kl = jax.random.split(ks)
            l_draws.append(light_draws(kl, -(-n // stride)))
            ks, sub = jax.random.split(ks)
            b_draws.append(np.asarray(jax.random.uniform(sub, (n, 2))))
        bnc.append(np.stack(b_draws))
        lgt.append(np.stack(l_draws))
    return (torch.as_tensor(np.stack(jit)) if jit else None,
            torch.as_tensor(np.stack(bnc)), torch.as_tensor(np.stack(lgt)))
