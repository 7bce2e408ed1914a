// Shared types of the ASA line parser.
//
// The line parser body (asaparse_line.inl) compiles once per ISA —
// scalar in asaparse.cpp, AVX2 in asaparse_avx2.cpp, NEON in
// asaparse_neon.cpp — and the chunk loops dispatch through a
// HandleLineFn pointer selected at runtime.  These types cross that
// boundary, so they live outside the per-ISA namespaces.

#pragma once

#include <cstdint>
#include <string>
#include <unordered_map>

namespace ra_parse {

struct Packer {
    // key: firewall + '\x01' + acl   -> acl gid  (named-ACL messages)
    //      firewall + '\x02' + iface -> acl gid  (in-direction binding)
    //      firewall + '\x03' + iface -> acl gid  (out-direction binding)
    std::unordered_map<std::string, uint32_t> resolve;
    int64_t parsed = 0;   // ACL evaluations emitted (LinePacker.parsed)
    int64_t skipped = 0;  // lines yielding none (LinePacker.skipped)
};

// Per-thread parse context: the shared resolve table is read-only during a
// parse; everything mutable is thread-local so N workers can parse one
// batch's line ranges concurrently (the Hadoop input-split analog,
// SURVEY.md §2 L2).
struct LocalCtx {
    const std::unordered_map<std::string, uint32_t>* resolve;
    std::string keybuf;
};

// Parse one line; emit its ACL evaluations into the column-major output.
// Same contract for every ISA build — see the documentation block on
// handle_line in asaparse_line.inl.
using HandleLineFn = int (*)(LocalCtx* pk, const char* ls, const char* le,
                             uint32_t* out, int64_t cap, int64_t row,
                             uint32_t* out6, int64_t cap6, int64_t* row6);

// Per-ISA entry points: return the TU's handle_line, or nullptr when the
// TU was compiled without the ISA or the CPU lacks it at runtime.
HandleLineFn scalar_handle_line();
HandleLineFn avx2_handle_line();
HandleLineFn neon_handle_line();

}  // namespace ra_parse
