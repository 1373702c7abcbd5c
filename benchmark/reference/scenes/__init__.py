"""Scene generators, one module a kind: make(spec, seed) returns the
arrays of a triangle scene as numpy (verts [V, 3] f32, faces [F, 3] i32
vertex indices, emission [F, 3] f32). A configuration file names its kind
under "scene"; a new kind is a new module here."""
