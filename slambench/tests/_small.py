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

# LOOP_SMALL's circuit (the port's scenes.py: 64-d, 512 slots, 170 frames over
# 2.25 turns, its loop thresholds but the cell's two consistent hits, so that
# the Sim3 refinement from the last keyframe runs): the correction comes at
# about frame 125, one an episode
REVISIT = ("synth-mono-1024.revisit", {
    "config": {"world": {"n_landmarks": 4000, "desc_dim": 64},
               "features": {"pad_to": 512, "noise_px": 0.3, "desc_noise": 0.03,
                            "max_per_frame": 480, "gdesc_dim": 64},
               "system": {"n_slots": 512, "desc_dim": 64, "gdesc_dim": 64},
               "mapper": {"ba_mp_cap": 2048, "ba_edge_cap": 8192},
               "loop": {"min_pair_matches": 30, "min_sim3_inliers": 15, "min_proj_matches": 30,
                        "gba_mp_cap": 4096, "gba_edge_cap": 16384}},
    "traffic": {"circuit_frames": 170, "laps": 1.125, "snapshot_frames": 100,
                "episode": [100, 145], "warmup_episodes": 0},
    "workload": {"check": {"samples": {"track_step": 4, "ba": 2, "sim3": 2, "pose_graph": 1,
                                       "gba": 1, "loops": 0}}}})
