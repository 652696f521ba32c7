from densepoints.io.ply import read_ply, write_mesh_ply, write_ply
from densepoints.io.scene import Scene, SceneSpec, load_scene, read_scene_json
