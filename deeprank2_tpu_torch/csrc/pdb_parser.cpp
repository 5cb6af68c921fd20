// PDB ATOM-record parser producing struct-of-arrays columns.
//
// Native replacement for the reference stack's pdb2sql (SQLite) structure
// loading; semantics match io/pdb.py's Python parser (parse_pdb_ref) exactly
// (first model, ATOM records only, altLoc ''/'A' only, highest occupancy wins
// for duplicate atom names within a residue).
//
// C ABI for ctypes. Returns the number of atoms parsed, or a negative error:
//   -1 file not found
//   -2 output capacity exceeded
//   -(1000 + line_no) unknown chemical element on 1-based line `line_no`
//     (the Python wrapper raises KeyError, reference parity).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

int element_value(const char* two, const char* name) {
    // columns 77-78 when present, else first alphabetic char of the atom name
    char symbol = 0;
    if (two[0] != 0 && !std::isspace(static_cast<unsigned char>(two[0]))) {
        symbol = two[0];
    } else if (two[1] != 0 && !std::isspace(static_cast<unsigned char>(two[1]))) {
        symbol = two[1];
    } else {
        for (const char* p = name; *p; ++p) {
            if (std::isalpha(static_cast<unsigned char>(*p))) { symbol = *p; break; }
        }
    }
    switch (std::toupper(static_cast<unsigned char>(symbol))) {
        case 'C': return 1;
        case 'O': return 2;
        case 'N': return 3;
        case 'S': return 4;
        case 'P': return 5;
        case 'H': return 6;
        default: return 0;
    }
}

double field_double(const char* line, int start, int len, double fallback) {
    char buf[16];
    std::snprintf(buf, sizeof(buf), "%.*s", len, line + start);
    char* end = nullptr;
    double v = std::strtod(buf, &end);
    return end == buf ? fallback : v;
}

void field_trim(const char* line, int start, int len, char* out) {
    int k = 0;
    for (int i = 0; i < len; ++i) {
        char c = line[start + i];
        if (c == 0 || c == '\n' || c == '\r') break;
        if (!std::isspace(static_cast<unsigned char>(c))) out[k++] = c;
    }
    out[k] = 0;
}

}  // namespace

extern "C" {

int64_t pdb_parse(
    const char* path,
    double* positions,      // [atom_cap * 3]
    char* atom_names,       // [atom_cap * 8] zero-padded
    int8_t* elements,       // [atom_cap]
    double* occupancies,    // [atom_cap]
    int32_t* atom_residue,  // [atom_cap]
    int32_t* res_numbers,   // [res_cap]
    char* res_icodes,       // [res_cap] (0 = none)
    char* res_names,        // [res_cap * 4] zero-padded
    int32_t* res_chain,     // [res_cap]
    char* chain_ids,        // [chain_cap]
    int64_t* counts,        // out: [n_atoms, n_res, n_chains]
    int64_t atom_cap,
    int64_t res_cap,
    int64_t chain_cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;

    int64_t n_atoms = 0, n_res = 0, n_chains = 0;
    std::unordered_map<std::string, int32_t> residue_index;   // "chain|num|icode"
    std::unordered_map<std::string, int64_t> atom_index;      // "res#|name"
    std::unordered_map<char, int32_t> chain_index;

    char line[256];
    int64_t line_no = 0;
    while (std::fgets(line, sizeof(line), f)) {
        ++line_no;
        size_t len = std::strlen(line);
        if (len < 6) continue;
        if (std::strncmp(line, "ENDMDL", 6) == 0) break;  // first model only
        if (std::strncmp(line, "ATOM  ", 6) != 0) continue;
        if (len < 54) continue;

        char altloc = line[16];
        if (altloc != ' ' && altloc != 'A' && altloc != 0) continue;

        char name[8];
        field_trim(line, 12, 4, name);
        char resname[8];
        field_trim(line, 17, 3, resname);
        char chain = line[21];
        if (chain == ' ') chain = 0;
        char numbuf[8];
        field_trim(line, 22, 4, numbuf);
        int32_t res_seq = static_cast<int32_t>(std::strtol(numbuf, nullptr, 10));
        char icode = line[26] == ' ' ? 0 : line[26];
        double x = field_double(line, 30, 8, 0.0);
        double y = field_double(line, 38, 8, 0.0);
        double z = field_double(line, 46, 8, 0.0);
        double occ = len >= 60 ? field_double(line, 54, 6, 1.0) : 1.0;

        char elem2[3] = {0, 0, 0};
        if (len >= 78) { elem2[0] = line[76]; elem2[1] = line[77]; }
        int ev = element_value(elem2, name);
        if (ev == 0) { std::fclose(f); return -(1000 + line_no); }

        if (chain_index.find(chain) == chain_index.end()) {
            if (n_chains >= chain_cap) { std::fclose(f); return -2; }
            chain_index[chain] = static_cast<int32_t>(n_chains);
            chain_ids[n_chains++] = chain ? chain : ' ';
        }

        std::string res_key;
        res_key.reserve(16);
        res_key.push_back(chain);
        res_key.push_back('|');
        res_key += numbuf;
        res_key.push_back('|');
        res_key.push_back(icode);
        auto rit = residue_index.find(res_key);
        int32_t r;
        if (rit == residue_index.end()) {
            if (n_res >= res_cap) { std::fclose(f); return -2; }
            r = static_cast<int32_t>(n_res);
            residue_index[res_key] = r;
            res_numbers[r] = res_seq;
            res_icodes[r] = icode;
            std::memset(res_names + r * 4, 0, 4);
            std::strncpy(res_names + r * 4, resname, 3);
            res_chain[r] = chain_index[chain];
            ++n_res;
        } else {
            r = rit->second;
        }

        std::string akey = std::to_string(r) + "|" + name;
        auto ait = atom_index.find(akey);
        if (ait != atom_index.end()) {
            int64_t prev = ait->second;
            if (occupancies[prev] < occ) {  // highest occupancy wins
                positions[prev * 3] = x;
                positions[prev * 3 + 1] = y;
                positions[prev * 3 + 2] = z;
                occupancies[prev] = occ;
            }
            continue;
        }

        if (n_atoms >= atom_cap) { std::fclose(f); return -2; }
        atom_index[akey] = n_atoms;
        positions[n_atoms * 3] = x;
        positions[n_atoms * 3 + 1] = y;
        positions[n_atoms * 3 + 2] = z;
        std::memset(atom_names + n_atoms * 8, 0, 8);
        std::strncpy(atom_names + n_atoms * 8, name, 7);
        elements[n_atoms] = static_cast<int8_t>(ev);
        occupancies[n_atoms] = occ;
        atom_residue[n_atoms] = r;
        ++n_atoms;
    }
    std::fclose(f);

    counts[0] = n_atoms;
    counts[1] = n_res;
    counts[2] = n_chains;
    return n_atoms;
}

}  // extern "C"
