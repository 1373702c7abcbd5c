"""Scene container: flat SoA tensors.

Port of clpathtracer_tpu/scene/scene.py. Sphere primitives stay as empty
tensors in this slice: the renderer raises NotImplementedError on a scene
that holds any.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    sphere_pos/radius/albedo/emission: [0, 3], [0], [0, 3], [0, 3].
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
               *, device) -> "Scene":
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
        z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
        return cls(verts=verts, faces=faces, normals=normals, albedo=albedo,
                   emission=emission, sphere_pos=z3,
                   sphere_radius=torch.zeros((0,), device=device),
                   sphere_albedo=z3, sphere_emission=z3)

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_pos.shape[0]

    def tri_verts(self):
        """Gathered corner positions (v0, v1, v2), each [F, 3]."""
        v = self.verts[self.faces[:, :, 0].long()]                # [F, 3, 3]
        return v[:, 0, :], v[:, 1, :], v[:, 2, :]

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
