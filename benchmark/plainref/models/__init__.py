"""Lidar odometry, mapping and their per-frame composition."""
