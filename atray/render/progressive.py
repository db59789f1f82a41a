"""Progressive rendering with checkpoint/resume.

The capability the reference lacks (SURVEY.md §5.4: renders restart from
scratch): the film is accumulated over batches of samples; the accumulator
state — film sum, sample count, PRNG key — checkpoints to an .npz after
every batch, so a preempted job resumes exactly where it stopped. The PRNG
key is counter-based (fold_in of the batch index), so resume is
bit-identical to an uninterrupted run.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from atray.config import RenderSettings
from atray.core.camera import Camera
from atray.render.wavefront import render


@dataclasses.dataclass
class FilmState:
    """Host-side accumulator (kept as numpy so checkpoints are trivial)."""

    film_sum: np.ndarray      # (H, W, 3) running sum of batch means
    batches_done: int
    spp_per_batch: int
    seed: int

    @property
    def spp_total(self) -> int:
        return self.batches_done * self.spp_per_batch

    def film(self) -> np.ndarray:
        if self.batches_done == 0:
            return np.zeros_like(self.film_sum)
        return np.clip(self.film_sum / self.batches_done, 0.0, 1.0)


def save_checkpoint(path: str, state: FilmState) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp,
        film_sum=state.film_sum,
        batches_done=state.batches_done,
        spp_per_batch=state.spp_per_batch,
        seed=state.seed,
    )
    # numpy appends .npz to the name it writes
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(path: str) -> Optional[FilmState]:
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return FilmState(
        film_sum=z["film_sum"],
        batches_done=int(z["batches_done"]),
        spp_per_batch=int(z["spp_per_batch"]),
        seed=int(z["seed"]),
    )


def render_progressive(
    scene,
    camera: Camera,
    settings: RenderSettings,
    total_spp: int,
    accel=None,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    on_batch: Optional[Callable[[FilmState], None]] = None,
    render_fn=None,
) -> FilmState:
    """Render ``total_spp`` samples in batches of settings.samples_per_pixel.

    Resumes from ``checkpoint_path`` if present (batch keys are derived
    from (seed, batch index) so the resumed run equals the uninterrupted
    one). ``on_batch`` is the live-progress hook — the SPMD stand-in for
    the reference's title-bar tile counter (app.cpp:174-181).
    ``render_fn(scene, camera, settings, key, accel)`` may override the
    renderer (e.g. dist.render_sharded bound to a mesh).
    """
    spb = settings.samples_per_pixel
    nbatches = -(-total_spp // spb)
    state = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if state is not None:
        if state.spp_per_batch != spb or state.seed != seed:
            raise ValueError(
                "checkpoint was created with different spp_per_batch/seed"
            )
    else:
        w, h = settings.resolution
        state = FilmState(
            film_sum=np.zeros((h, w, 3), np.float32),
            batches_done=0,
            spp_per_batch=spb,
            seed=seed,
        )

    base = jax.random.PRNGKey(seed)
    rfn = render_fn or (
        lambda sc, cam, st, key, acc: render(sc, cam, st, key, accel=acc)
    )
    jrender = jax.jit(lambda key: rfn(scene, camera, settings, key, accel))

    for b in range(state.batches_done, nbatches):
        key = jax.random.fold_in(base, b)
        film = np.asarray(jrender(key))
        state.film_sum = state.film_sum + film
        state.batches_done = b + 1
        if checkpoint_path and (b + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state)
        if on_batch is not None:
            on_batch(state)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, state)
    return state
