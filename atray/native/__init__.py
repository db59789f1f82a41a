from atray.native.bindings import (
    available,
    build_bvh_native,
    ensure_built,
    parse_obj_native,
)
