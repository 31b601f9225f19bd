"""OpenAPI description of the REST service.

The reference generates openapi.json from @api comment blocks with
swagger-inline and serves it with a Swagger UI at /docs
(compose/nginx.conf:41-60, svc-src/gen_doc_api.sh); here the spec is
a literal document served at GET /docs/openapi.json, with a minimal
HTML viewer at GET /docs.
"""

from __future__ import annotations

_ERROR_RESPONSE = {
    "description": "Error",
    "content": {"application/json": {"schema": {
        "type": "object",
        "properties": {"error": {
            "type": "object",
            "properties": {
                "code": {
                    "type": "integer",
                    "description": (
                        "0 success; 1 fatal; 2 system; 3 invalid "
                        "param/value; 4 already exists; 5 missing; "
                        "6 limit reached"),
                },
                "msg": {"type": "string"},
            },
        }},
    }}},
}

_SEARCH_RESULT = {
    "type": "object",
    "properties": {
        "results": {"type": "array", "items": {
            "type": "object",
            "properties": {
                "doc_id": {"type": "integer", "format": "int64"},
                "score": {"type": "number"},
                "content": {"type": "string",
                            "description": "present with ?fetch"},
            },
        }},
        "count": {"type": "integer"},
    },
}

_SEARCH_PARAMS = [
    {"name": "algo", "in": "query", "schema": {"type": "string"},
     "description": "Ranking algorithm override (BM25 or TF-IDF)"},
    {"name": "limit", "in": "query", "schema": {"type": "integer"},
     "description": "Results cap (default 1000)"},
    {"name": "fuzzymatch", "in": "query", "schema": {"type": "boolean"},
     "description": "Fuzzy-match terms (default true)"},
    {"name": "fetch", "in": "query", "schema": {"type": "boolean"},
     "description": "Join stored raw content into results"},
]

OPENAPI = {
    "openapi": "3.0.3",
    "info": {
        "title": "nxsearch-tpu",
        "description": "GPU-resident full-text search engine REST API",
        "version": "0.1.0",
    },
    "paths": {
        "/{index}": {
            "post": {
                "summary": "Create an index",
                "parameters": [{"name": "index", "in": "path",
                                "required": True,
                                "schema": {"type": "string"}}],
                "requestBody": {"content": {"application/json": {"schema": {
                    "type": "object",
                    "properties": {
                        "filters": {"type": "array",
                                    "items": {"type": "string"}},
                        "lang": {"type": "string"},
                        "algo": {"type": "string",
                                 "enum": ["BM25", "TF-IDF"]},
                    },
                }}}},
                "responses": {"201": {"description": "Created"},
                              "400": _ERROR_RESPONSE},
            },
            "delete": {
                "summary": "Destroy an index",
                "parameters": [{"name": "index", "in": "path",
                                "required": True,
                                "schema": {"type": "string"}}],
                "responses": {"200": {"description": "OK"},
                              "400": _ERROR_RESPONSE},
            },
        },
        "/{index}/add/{doc_id}": {
            "post": {
                "summary": "Add a document",
                "parameters": [
                    {"name": "index", "in": "path", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "doc_id", "in": "path", "required": True,
                     "schema": {"type": "integer", "format": "int64"}},
                    {"name": "store", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "Keep the raw text (for ?fetch)"},
                ],
                "requestBody": {"required": True, "content": {
                    "text/plain": {"schema": {"type": "string"}}}},
                "responses": {"201": {"description": "Created"},
                              "400": _ERROR_RESPONSE},
            },
        },
        "/{index}/remove/{doc_id}": {
            "delete": {
                "summary": "Remove a document",
                "parameters": [
                    {"name": "index", "in": "path", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "doc_id", "in": "path", "required": True,
                     "schema": {"type": "integer", "format": "int64"}},
                ],
                "responses": {"200": {"description": "OK"},
                              "400": _ERROR_RESPONSE},
            },
        },
        "/{index}/search": {
            "post": {
                "summary": "Search the index",
                "parameters": [
                    {"name": "index", "in": "path", "required": True,
                     "schema": {"type": "string"}},
                    *_SEARCH_PARAMS,
                ],
                "requestBody": {"required": True, "content": {
                    "text/plain": {"schema": {"type": "string"}}}},
                "responses": {
                    "200": {"description": "OK", "content": {
                        "application/json": {"schema": _SEARCH_RESULT}}},
                    "400": _ERROR_RESPONSE,
                },
            },
        },
        "/{index}/search_batch": {
            "post": {
                "summary": "Search many queries in one call "
                           "(batched device execution)",
                "parameters": [
                    {"name": "index", "in": "path", "required": True,
                     "schema": {"type": "string"}},
                    *_SEARCH_PARAMS[:3],
                ],
                "requestBody": {"required": True, "content": {
                    "application/json": {"schema": {
                        "type": "object",
                        "properties": {"queries": {
                            "type": "array",
                            "items": {"type": "string"}}},
                    }}}},
                "responses": {
                    "200": {"description": "OK", "content": {
                        "application/json": {"schema": {
                            "type": "object",
                            "properties": {"responses": {
                                "type": "array",
                                "items": _SEARCH_RESULT}},
                        }}}},
                    "400": _ERROR_RESPONSE,
                },
            },
        },
        "/filters/{name}/py": {
            "post": {
                "summary": "Load a Python filter plugin "
                           "(requires NXS_ENABLE_PY_POST)",
                "parameters": [
                    {"name": "name", "in": "path", "required": True,
                     "schema": {"type": "string"}},
                    {"name": "store", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "Persist under filters/"},
                ],
                "requestBody": {"required": True, "content": {
                    "text/plain": {"schema": {
                        "type": "string",
                        "description": "Python filter source"}}}},
                "responses": {"201": {"description": "Created"},
                              "400": _ERROR_RESPONSE},
            },
        },
    },
}

DOCS_HTML = """<!DOCTYPE html>
<html>
<head><title>nxsearch-tpu API</title></head>
<body>
<h1>nxsearch-tpu REST API</h1>
<p>The OpenAPI document is at <a href="/docs/openapi.json">
/docs/openapi.json</a>; point any Swagger/OpenAPI viewer at it.</p>
</body>
</html>
"""
