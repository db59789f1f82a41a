from atray.render.wavefront import (
    HitIds,
    draw_bounce_uniforms,
    nearest_hit_ids,
    render,
    resolve_hit,
    trace_radiance,
)
from atray.render.film import linear_to_srgb, save_png, to_uint8
from atray.render.aov import aov_preview_films, render_aovs
