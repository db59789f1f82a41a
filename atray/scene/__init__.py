from atray.scene.data import (
    Materials,
    Planes,
    Scene,
    SceneParams,
    Spheres,
    TriMesh,
    build_scene,
)
from atray.scene.objio import load_obj, save_obj
from atray.scene import procedural, transforms
