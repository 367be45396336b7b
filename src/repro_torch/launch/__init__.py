"""Launch helpers of the port: the grid tier's device list and sharding
(`mesh`)."""
