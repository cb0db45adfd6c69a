"""CLI apps of the port: `view` (the headless viewer) with its numpy-only
camera rig and sequencer, and `bake` (glTF meshes into the bake cache)."""
