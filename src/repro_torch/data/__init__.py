"""The synthetic token stream and its prefetcher (port of `repro.data`)."""
