"""Host-side CSPRNG: ChaCha20 in numpy and torch generators seeded from it."""
