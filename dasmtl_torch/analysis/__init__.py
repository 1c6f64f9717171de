"""Run-time analysis of the port: the step guards (:mod:`.guards`) and the
SAN201-203 sanitizers (:mod:`.sanitize`).  The JAX package's source lint,
HLO audit, concurrency, memory and surface families analyse JAX code and
have no counterpart here."""
