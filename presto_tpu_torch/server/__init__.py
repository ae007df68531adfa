"""The cluster: sessions, query lifecycle, the statement protocol, and the
coordinator and worker services over HTTP (reference: presto-main
server/ + execution/ packages; the JAX package's server/)."""
