"""CLI apps of the port: `view` (the headless viewer) and its numpy-only
camera rig and sequencer."""
