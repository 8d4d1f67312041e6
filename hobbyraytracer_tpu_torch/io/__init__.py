"""Host-side image codecs (numpy + stdlib)."""
