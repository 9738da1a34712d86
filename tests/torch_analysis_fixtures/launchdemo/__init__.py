"""launchdemo: a miniature of the port's kernel plane for the launch
domain (HSL015 and HSL023-026). Three wrappers — one that keeps its
launch contract, one whose launch path leaks host effects, one with a
fallback — and a staging module that mutates a borrowed buffer. Parsed,
never imported."""
