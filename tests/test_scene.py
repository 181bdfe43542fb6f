import numpy as np

from pathtracer.models.bsdf import (
    MATERIAL_DIFFUSE,
    MATERIAL_MIRROR,
    MATERIAL_SMOOTH_DIELECTRIC,
    MATERIAL_SMOOTH_PLASTIC,
)
from pathtracer.scene import load_obj, load_scene, scene_path


def test_cornellbox_counts():
    scene = load_scene(scene_path("cornellbox"))
    assert scene.num_triangles == 36
    assert scene.num_lights == 2
    # two equal-area light triangles -> pdf 0.5 each, exclusive-prefix cdf
    np.testing.assert_allclose(np.asarray(scene.light_pdf), [0.5, 0.5, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.light_cdf), [0.0, 0.5, 1.0], atol=1e-6)
    # light area = 0.47 * 0.44 quad split in two
    np.testing.assert_allclose(
        np.asarray(scene.light_area[:2]), 0.47 * 0.44 / 2.0, rtol=1e-4
    )
    # the light triangles are #8 and #9 (after ceiling/floor/frontWall/leftWall)
    assert list(np.asarray(scene.light_tri[:2])) == [8, 9]
    li = np.asarray(scene.light_index)
    assert li[8] == 0 and li[9] == 1 and (li[:8] == -1).all() and (li[10:] == -1).all()
    # all materials diffuse; emissive = Ka 5 4 3 on 'light'
    assert (np.asarray(scene.mat_type) == MATERIAL_DIFFUSE).all()
    np.testing.assert_allclose(np.asarray(scene.light_emissive[:, 0]), [5.0, 4.0, 3.0])


def test_water_plastic_material_classification():
    scene = load_scene(scene_path("CornellBox-Water-plastic"))
    assert scene.num_triangles == 7088
    mesh = load_obj(scene_path("CornellBox-Water-plastic"))
    names = [m.name for m in mesh.materials]
    mtype = np.asarray(scene.mat_type)
    ior = np.asarray(scene.mat_ior)
    by = dict(zip(names, mtype))
    assert by["leftSphere"] == MATERIAL_SMOOTH_PLASTIC
    assert ior[names.index("leftSphere")] == np.float32(1.5)  # abs(-1.5)
    assert by["rightSphere"] == MATERIAL_MIRROR
    assert by["water"] == MATERIAL_SMOOTH_PLASTIC  # Ks 0 0 -1.33333
    assert by["floor"] == MATERIAL_DIFFUSE


def test_water_dielectric_variant():
    mesh = load_obj(scene_path("CornellBox-Water"))
    scene = load_scene(scene_path("CornellBox-Water"))
    names = [m.name for m in mesh.materials]
    by = dict(zip(names, np.asarray(scene.mat_type)))
    assert by["water"] == MATERIAL_SMOOTH_PLASTIC  # Ks 0 0 -1.33333 -> plastic
    assert by["rightSphere"] == MATERIAL_SMOOTH_PLASTIC  # Ks 0 0 -1.76
    assert by["leftSphere"] == MATERIAL_DIFFUSE  # Ks 1 0 0 -> roughness 1


def test_whitebox_shares_cornellbox_mtl():
    scene = load_scene(scene_path("white-box"))
    assert scene.num_triangles == 12
    assert scene.num_lights == 2
    np.testing.assert_allclose(
        np.asarray(scene.light_emissive[:, 0]), [3.1415926536] * 3, rtol=1e-6
    )


def test_normals_unit_length():
    scene = load_scene(scene_path("CornellBox-Water-mirror"))
    for n in (scene.n0, scene.n1, scene.n2):
        lens = np.linalg.norm(np.asarray(n), axis=0)  # (3, T) component-major
        np.testing.assert_allclose(lens, 1.0, atol=1e-3)
