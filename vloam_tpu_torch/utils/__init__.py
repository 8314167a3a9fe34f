"""Host utilities: trajectory export, KITTI metrics, stage timing, checkpoints."""
