"""Multi-device rendering: spatial shards of one frame over a device grid."""
