"""Entry points of the port: the multi-tenant CPD service
(`launch.serve_cpd`)."""
