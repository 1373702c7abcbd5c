"""Scene container: flat SoA tensors.

Port of clpathtracer_tpu/scene/scene.py: triangles and spheres.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class Scene(TensorStruct):
    """Triangle scene.

    verts:    [V, 3] f32 vertex positions.
    faces:    [F, 3, 3] i32, faces[f, corner] = (v_idx, vn_idx, vt_idx);
              -1 marks an absent normal/texcoord index.
    normals:  [VN, 3] f32 vertex normals (row 0 is a placeholder when the
              mesh has none).
    albedo:   [F, 3] f32 per-face diffuse reflectance.
    emission: [F, 3] f32 per-face radiant exitance.
    sphere_pos/radius/albedo/emission: [S, 3], [S], [S, 3], [S, 3] f32
              (S = 0 without spheres).
    shade_rows: optional [F, 16] baked shading rows (n0, n1, n2, albedo,
              emission, pad); see bake_shading().
    """

    verts: torch.Tensor
    faces: torch.Tensor
    normals: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    sphere_pos: torch.Tensor
    sphere_radius: torch.Tensor
    sphere_albedo: torch.Tensor
    sphere_emission: torch.Tensor
    shade_rows: torch.Tensor = None

    @classmethod
    def create(cls, verts, faces, normals=None, albedo=None, emission=None,
               sphere_pos=None, sphere_radius=None, sphere_albedo=None,
               sphere_emission=None, *, device) -> "Scene":
        def f32(x):
            return torch.as_tensor(np.array(x, np.float32), device=device)
        verts = f32(verts).reshape(-1, 3)
        faces = torch.as_tensor(np.array(faces, np.int32),
                                device=device).reshape(-1, 3, 3)
        nf = faces.shape[0]
        if normals is None or np.asarray(normals).size == 0:
            normals = torch.zeros((1, 3), dtype=torch.float32, device=device)
        else:
            normals = f32(normals).reshape(-1, 3)
        albedo = (torch.full((nf, 3), 0.75, device=device) if albedo is None
                  else f32(albedo).expand(nf, 3).contiguous())
        emission = (torch.zeros((nf, 3), device=device) if emission is None
                    else f32(emission).expand(nf, 3).contiguous())
        sphere_pos = (np.zeros((0, 3), np.float32) if sphere_pos is None
                      else sphere_pos)
        sphere_pos = f32(sphere_pos).reshape(-1, 3)
        ns = sphere_pos.shape[0]
        sphere_radius = (torch.zeros((0,), device=device) if ns == 0
                         else f32(sphere_radius).reshape(ns))
        sphere_albedo = (torch.full((ns, 3), 0.75, device=device)
                         if sphere_albedo is None
                         else f32(sphere_albedo).expand(ns, 3).contiguous())
        sphere_emission = (torch.zeros((ns, 3), device=device)
                           if sphere_emission is None else
                           f32(sphere_emission).expand(ns, 3).contiguous())
        return cls(verts=verts, faces=faces, normals=normals, albedo=albedo,
                   emission=emission, sphere_pos=sphere_pos,
                   sphere_radius=sphere_radius, sphere_albedo=sphere_albedo,
                   sphere_emission=sphere_emission)

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_pos.shape[0]

    def with_verts(self, verts: torch.Tensor) -> "Scene":
        """The scene with new vertex positions (a new object, so that
        tri_records is built again from them)."""
        return self.replace(verts=verts)

    def tri_verts(self):
        """Gathered corner positions (v0, v1, v2), each [F, 3]."""
        v = vm.take_rows(self.verts, self.faces[:, :, 0])         # [F, 3, 3]
        return v[:, 0, :], v[:, 1, :], v[:, 2, :]

    @functools.cached_property
    def tri_records(self) -> torch.Tensor:
        """The triangles as [F, 16] records in index order, the flat scan's
        (ops/intersect.py::brute_force): (v0, e1, e2, tri_id, pad 6), e1 =
        v1 - v0 and e2 = v2 - v0 rounded in f32 as moller_trumbore rounds
        them. Built at first use and kept with this scene (replace() and
        to() give a scene that builds its own)."""
        v0, v1, v2 = self.tri_verts()
        f = v0.shape[0]
        ids = torch.arange(f, dtype=torch.float32, device=v0.device)[:, None]
        pad = torch.zeros((f, 6), dtype=torch.float32, device=v0.device)
        return torch.cat([v0, v1 - v0, v2 - v0, ids, pad], dim=1).contiguous()

    def tri_corners(self) -> np.ndarray:
        """Host-side [F, 3, 3] corner positions in face-winding order: the
        array the window builder expects."""
        v = self.verts.cpu().numpy()
        return v[self.faces[:, :, 0].cpu().numpy()]

    def bake_shading(self) -> "Scene":
        """Precompute [F, 16] per-triangle shading rows on the host.

        Per-corner normals are the vertex normals when the face carries
        them (all three indices >= 0), else the geometric normal
        replicated, so interpolation reproduces either case from one row.
        """
        v = self.verts.cpu().numpy()
        f = self.faces.cpu().numpy()
        nrm = self.normals.cpu().numpy()
        nf = f.shape[0]
        p0, p1, p2 = v[f[:, 0, 0]], v[f[:, 1, 0]], v[f[:, 2, 0]]
        g = np.cross(p1 - p0, p2 - p0)
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-30)
        has = (f[:, :, 1] >= 0).all(axis=-1)
        safe = np.maximum(f[:, :, 1], 0)
        corner = nrm[safe]                                         # [F, 3, 3]
        corner = np.where(has[:, None, None], corner,
                          np.repeat(g[:, None, :], 3, axis=1))
        rows = np.zeros((nf, 16), np.float32)
        rows[:, 0:9] = corner.reshape(nf, 9)
        rows[:, 9:12] = self.albedo.cpu().numpy()
        rows[:, 12:15] = self.emission.cpu().numpy()
        return self.replace(
            shade_rows=torch.as_tensor(rows, device=self.verts.device))
