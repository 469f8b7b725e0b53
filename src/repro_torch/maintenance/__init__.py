"""Index lifecycle: tombstone masks for delete and TTL expiry."""
