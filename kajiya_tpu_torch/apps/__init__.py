"""CLI apps of the port: `view` (the headless viewer, with `--watch` hot
reload) with its numpy-only camera rig and sequencer, `stream` (the live
HTTP viewer), `hello` (the minimal embedding example), `bake` (glTF meshes
into the bake cache), and the viewer's `keymap` and `persisted` state."""
