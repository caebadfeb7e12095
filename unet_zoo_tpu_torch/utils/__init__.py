"""Weight conversion and serving helpers of the port."""
