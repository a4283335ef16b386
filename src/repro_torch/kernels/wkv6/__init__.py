"""RWKV6 WKV: the time-mix recurrence with per-channel data-dependent
decay and the current-token bonus."""
