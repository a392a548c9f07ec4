"""Pool protocol clients."""
