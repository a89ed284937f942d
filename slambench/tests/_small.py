"""A small version of the cell, for runs on the CPU in the tests: the same
code paths at sizes a test can hold."""

ORBIT = ("hfnet-rgbd-640x480.orbit", {
    "config": {"camera": {"fx": 112.0, "fy": 112.0, "cx": 80.0, "cy": 60.0, "width": 160,
                          "height": 120},
               "extractor": {"n_features": 200, "n_levels": 2, "pad_to": 256,
                             "train": {"n_steps": 5, "n_pairs": 64, "n_frames_cache": 6}},
               "system": {"k_max": 32, "m_max": 4096, "n_slots": 256}},
    "traffic": {"phases": [0, 12], "frames": 12, "warmup_frames": 4},
    "workload": {"check": {"samples": {"extract": 2, "track_step": 4, "ba": 3}}}})
